"""The store and dataset tools: what a user runs on a finished map store
or a recorded sequence.

Port of the store and dataset tools of ``rtabmap_tpu/tools/cli.py`` (the
reference's rtabmap-info, -reprocess, -export, -recovery,
-detectMoreLoopClosures, -globalBundleAdjustment and -reduceGraph; the
TUM, KITTI, EuRoC and CID-SIMS dataset tools and stereoEval; the Matcher
tool and the learned models' weight converter; ``db_edit``, the
DatabaseViewer's edits), with the twin's argument syntax. Run as

    python -m rtabmap_tpu_torch.tools.cli <tool> [args...] [--device cpu]

``--device`` picks the device (the CUDA card by default). Every other tool
of the twin's ``TOOLS`` raises ``NotImplementedError`` naming the slice
that brings it.

Kept from the twin: ``detect_more_loop_closures`` and ``global_ba``
build a fixed 320x240 camera (fx = fy = 300) whatever the store recorded;
``reprocess`` takes the store's ``__camera__`` parameter (the engine's
``close()`` writes it) and the fixed camera when there is none.
``export_cloud --mesh`` fuses the stored depth frames into a TSDF volume
over the camera centres +- (min(5 m, the largest depth) + margin), so a
wall farther away may fall outside it; the tool prints which planes of the
box the mesh's vertices reach, and returns its record (counts, stage
times, the mesh).
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

# the camera the twin's store tools assume when the store names none
_FIXED_CAMERA = (300.0, 300.0, 160.0, 120.0, 320, 240)


def _take(argv: List[str], flag: str, default: Optional[str] = None) -> Tuple[Optional[str], List[str]]:
    """(value of ``flag``, argv without the flag and its value)."""
    if flag not in argv:
        return default, list(argv)
    k = argv.index(flag)
    return argv[k + 1], argv[:k] + argv[k + 2:]


def _device(argv: List[str], resolve: bool = True):
    """Strip ``--device`` from argv: (the device, resolved unless
    ``resolve`` is false, the rest)."""
    from rtabmap_tpu_torch.device import resolve_device

    dev, argv = _take(argv, "--device")
    return (resolve_device(dev) if resolve else dev), argv


def tool_info(argv: List[str]):
    """Map store summary (rtabmap-info)."""
    from rtabmap_tpu_torch.memory.db import Database

    _, argv = _device(argv, resolve=False)
    db = Database(argv[0], async_writes=False)
    ids = db.all_node_ids()
    links = db.all_links()
    admin = db.load_admin()
    by_type = {}
    for lk in links:
        by_type[lk.type] = by_type.get(lk.type, 0) + 1
    info = {
        "path": argv[0], "version": admin["version"],
        "nodes": len(ids), "sessions": db.max_map_id() + 1,
        "links": len(links), "links_by_type": by_type,
        "optimized_poses": len(admin["optimized_poses"]),
        "vocabulary_words": admin["vocab"]["n_words"] if admin["vocab"] else 0,
        "parameters": len(admin["parameters"]),
    }
    print(json.dumps(info, indent=2))
    db.close()
    return info


def tool_reprocess(argv: List[str]):
    """Re-run SLAM over the nodes of one or more stores (rtabmap-reprocess):
    ``reprocess [--Group/Name value ...] "in1.db[;in2.db...]" [out.db]``.
    The parameters and camera come from the first store; each further
    store is appended as a new session. Returns the engine."""
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.memory.db_reader import signature_frame
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    in_paths = [p for p in rest[0].split(";") if p]
    out_path = rest[1] if len(rest) > 1 else None
    src0 = Database(in_paths[0], async_writes=False)
    stored = src0.load_admin()["parameters"]
    merged = Parameters()
    for k, v in stored.items():
        if merged.exists(k):
            merged.set(k, v)
    merged.update(params.overrides())
    cam = C.CameraModel.make(*(stored.get("__camera__") or _FIXED_CAMERA))
    out_db = Database(out_path) if out_path else None
    slam = Rtabmap(cam, merged, db=out_db, device=dev)
    n = sessions = 0
    for pi, path in enumerate(in_paths):
        src = src0 if pi == 0 else Database(path, async_writes=False)
        if pi > 0:
            slam.trigger_new_map()
        sessions += 1
        for sid in src.all_node_ids():
            sig = src.load_signature(sid)
            if sig is None or sig.word_ids is None:
                continue
            valid = (np.asarray(sig.word_ids) >= 0) | (
                np.abs(np.asarray(sig.desc, np.int32)).sum(-1) > 0)
            slam.process(signature_frame(sig, dev, valid), sig.pose, np.eye(6) * 1e-4,
                         stamp=sig.stamp)
            n += 1
        src.close()
    print(f"reprocessed {n} nodes from {sessions} database(s); loops in new run: "
          f"{sum(1 for s in slam.stats_history if s.loop_closure_id)}")
    if out_db:
        slam.close()
        out_db.close()
    return slam


def tool_export(argv: List[str]):
    """Export the optimized poses of a store (rtabmap-export --poses):
    ``export <db> <out> [format]``, formats 0-4 as ``export_poses``."""
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.tools.export_poses import export_poses

    _, argv = _device(argv, resolve=False)
    db_path, out_path = argv[0], argv[1]
    fmt = int(argv[2]) if len(argv) > 2 else 2
    db = Database(db_path, async_writes=False)
    poses = db.load_admin()["optimized_poses"]
    export_poses(out_path, fmt, poses, links=db.all_links())
    print(f"exported {len(poses)} poses (format {fmt}) -> {out_path}")
    db.close()


def tool_recovery(argv: List[str]):
    """Rebuild a usable store from an unclosed or damaged one
    (rtabmap-recovery): ``recovery <in.db> <out.db>``."""
    from rtabmap_tpu_torch.memory.db_reader import database_recovery

    dev, argv = _device(argv)
    out = database_recovery(argv[0], argv[1], device=dev)
    print(json.dumps(out))
    return out


def _load_engine(argv: List[str]):
    """(engine resumed on the store without a new session, the store, the
    remaining arguments)."""
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    db = Database(rest[0])
    cam = C.CameraModel.make(*_FIXED_CAMERA)
    return Rtabmap.load(db, cam, params, new_session=False, device=dev), db, rest


def tool_detect_more_loop_closures(argv: List[str]):
    """Offline closure sweep over a store (rtabmap-detectMoreLoopClosures):
    ``detect_more_loop_closures <db> [radius]``."""
    slam, db, rest = _load_engine(argv)
    radius = float(rest[1]) if len(rest) > 1 else 1.0
    added = slam.detect_more_loop_closures(cluster_radius=radius)
    print(f"added {added} loop closures")
    slam.close()
    db.close()
    return added


def tool_global_ba(argv: List[str]):
    """Global bundle adjustment over a store
    (rtabmap-globalBundleAdjustment): ``global_ba <db>``."""
    slam, db, _ = _load_engine(argv)
    ok = slam.global_bundle_adjustment()
    print(f"global BA: {'ok' if ok else 'skipped'}")
    slam.close()
    db.close()
    return ok


def tool_export_cloud(argv: List[str]):
    """Assemble and export the map's cloud or mesh (rtabmap-export):
    ``export_cloud <db> <out.(ply|obj)> [--mesh] [--texture] [--voxel V]
    [--cam fx,fy,cx,cy,w,h]``. ``--mesh`` fuses the stored depth frames
    into a TSDF and writes its mesh; ``--texture`` also bakes an atlas from
    the stored images (frames kept with Mem/BinDataKept). Returns the
    point count of a cloud, the record of a mesh (``_export_mesh``)."""
    from rtabmap_tpu_torch.geometry import transform as T
    from rtabmap_tpu_torch.maps.mesh import write_ply
    from rtabmap_tpu_torch.memory.db import Database

    dev, argv = _device(argv)
    db_path, out_path = argv[0], argv[1]
    opts = argv[2:]
    if "--mesh" in opts or "--texture" in opts:
        return _export_mesh(db_path, out_path, opts, dev)
    db = Database(db_path, async_writes=False)
    admin = db.load_admin()
    clouds = []
    for sid in db.all_node_ids():
        sig = db.load_signature(sid)
        if sig is None or sig.pts3d is None:
            continue
        pose = torch.from_numpy(np.array(admin["optimized_poses"].get(sid, sig.pose),
                                         np.float32))
        world = T.apply(pose[None], torch.from_numpy(np.array(sig.pts3d))[None])[0].numpy()
        clouds.append(world[np.asarray(sig.valid3d, bool)])
    cloud = np.concatenate(clouds) if clouds else np.zeros((0, 3))
    write_ply(out_path, cloud)
    print(f"exported {len(cloud)} points -> {out_path}")
    db.close()
    return len(cloud)


def _box_planes(verts: np.ndarray, lo: np.ndarray, hi: np.ndarray, voxel: float) -> List[str]:
    """The faces of the volume's box (``-x``, ``+y``, ...) that the mesh's
    vertices reach within a voxel and a half."""
    out = []
    for a, name in enumerate("xyz"):
        if len(verts) and (verts[:, a] <= lo[a] + 1.5 * voxel).any():
            out.append(f"-{name}")
        if len(verts) and (verts[:, a] >= hi[a] - 1.5 * voxel).any():
            out.append(f"+{name}")
    return out


def tsdf_box(centers: np.ndarray, depths, voxel: float):
    """The export's volume: (origin, size, voxel) of the camera centres
    (N,3) +- (the largest finite depth, at most 5 m, and a margin for the
    voxels behind the surfaces), the voxel grown so that no side passes
    192 voxels."""
    zmax = min(5.0, float(max(np.nanmax(d[np.isfinite(d)], initial=1.0) for d in depths)))
    margin = 0.25 * zmax + 0.2
    lo = centers.min(0) - zmax - margin
    hi = centers.max(0) + zmax + margin
    return lo, hi - lo, max(voxel, float(np.max(hi - lo)) / 192)


def _export_mesh(db_path: str, out_path: str, opts: List[str], dev) -> dict:
    """TSDF-fuse the stored raw frames at their optimized poses and write the
    mesh, or with ``--texture`` a textured OBJ (util3d_surface meshing +
    createTextureMesh + multiband). Returns the export's record: the
    volume, the vertex and face counts, the box planes the mesh reaches,
    the stage times (ms), the output path and the mesh (``(vertices,
    faces)``, or the ``TexturedMesh`` with the atlas size and the faces
    observed)."""
    import time

    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.maps.mesh import write_ply
    from rtabmap_tpu_torch.maps.texture import texture_mesh, write_textured_obj
    from rtabmap_tpu_torch.maps.tsdf import TSDFVolume
    from rtabmap_tpu_torch.memory.db import Database

    def opt(flag, default):
        return opts[opts.index(flag) + 1] if flag in opts else default

    ms = {}
    t0 = time.perf_counter()
    voxel = float(opt("--voxel", "0.05"))
    db = Database(db_path, async_writes=False)
    admin = db.load_admin()
    frames = []
    for sid in db.all_node_ids():
        raw = db.load_raw_frame(sid)
        if raw is None or raw[1] is None:
            continue
        img, depth, calib = raw
        sig = db.load_signature(sid)
        pose = admin["optimized_poses"].get(sid, sig.pose if sig is not None else None)
        if pose is None:
            continue
        frames.append((np.asarray(pose, np.float32), img, np.asarray(depth, np.float32), calib))
    if not frames:
        db.close()
        raise SystemExit("no raw depth frames stored in this database "
                         "(record with Mem/BinDataKept or data_recorder)")
    ms["load"] = (time.perf_counter() - t0) * 1e3
    H, W = frames[0][2].shape
    if "--cam" in opts:
        fx, fy, cx, cy, w, h = (float(x) for x in opt("--cam", "").split(","))
        cam = C.CameraModel.make(fx, fy, cx, cy, int(w), int(h))
    elif frames[0][3]:
        c = json.loads(frames[0][3])
        cam = C.CameraModel.make(c["fx"], c["fy"], c["cx"], c["cy"],
                                 c.get("width", W), c.get("height", H))
    else:
        f = 0.9 * W
        cam = C.CameraModel.make(f, f, W / 2.0, H / 2.0, W, H)

    lo, size, vox = tsdf_box(np.stack([p[:, 3] for p, *_ in frames]),
                             [d for _, _, d, _ in frames], voxel)
    t1 = time.perf_counter()
    vol = TSDFVolume(lo, size, voxel=vox, device=dev)
    for pose, _, depth, _ in frames:
        vol.integrate(depth, pose, cam)
    verts, faces = vol.extract_mesh()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms["tsdf_and_surface_nets"] = (time.perf_counter() - t1) * 1e3
    vh = verts.cpu().numpy()
    box_hi = lo + np.asarray(vol.dims) * vol.voxel
    record = dict(frames=len(frames), volume_dims=list(vol.dims), voxel=vol.voxel,
                  box_lo=lo.tolist(), box_hi=box_hi.tolist(), vertices=len(vh),
                  faces=int(faces.shape[0]),
                  box_planes_reached=_box_planes(vh, lo, box_hi, vol.voxel), ms=ms)
    print(f"volume {vol.dims} at {vol.voxel:.4f} m over {np.round(lo, 2).tolist()} .. "
          f"{box_hi.round(2).tolist()}; mesh vertices reach the box planes "
          f"{record['box_planes_reached'] or 'none'}")
    if "--texture" in opts and any(f[1] is not None for f in frames):
        t2 = time.perf_counter()
        kept = [f for f in frames if f[1] is not None]
        imgs = [np.asarray(f[1], np.float32) for f in kept]
        imgs = [im / 255.0 if im.max() > 2.0 else im for im in imgs]
        tm = texture_mesh(verts, faces, [f[0] for f in kept], cam, imgs,
                          depths=[f[2] for f in kept])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms["texture"] = (time.perf_counter() - t2) * 1e3
        if not out_path.endswith(".obj"):
            out_path = out_path.rsplit(".", 1)[0] + ".obj"
        t3 = time.perf_counter()
        write_textured_obj(out_path, tm)
        ms["write"] = (time.perf_counter() - t3) * 1e3
        record.update(atlas_px=int(tm.atlas.shape[0]), out=out_path,
                      faces_observed=int((tm.face_camera >= 0).sum()), mesh=tm)
        print(f"exported textured mesh: {len(vh)} verts, {int(faces.shape[0])} faces, "
              f"atlas {tm.atlas.shape[0]}px -> {out_path}")
    else:
        t3 = time.perf_counter()
        write_ply(out_path, verts, faces=faces)
        ms["write"] = (time.perf_counter() - t3) * 1e3
        record.update(out=out_path, mesh=(verts, faces))
        print(f"exported mesh: {len(vh)} verts, {int(faces.shape[0])} faces -> {out_path}")
    db.close()
    return record


def tool_reduce_graph(argv: List[str]):
    """Prune nodes, composing their neighbour links (rtabmap-reduceGraph):
    ``reduce_graph in.db out.db [keep_every=2]``. Closure nodes and every
    k-th node stay; a removed node's neighbour links merge into one
    LINK_NEIGHBOR_MERGED with the composed transform and the weaker
    information."""
    from rtabmap_tpu_torch.geometry import transform as T
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.memory.memory import LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED, Link
    from rtabmap_tpu_torch.utils.params import Parameters

    _, argv = _device(argv, resolve=False)
    _, rest = Parameters.parse_arguments(argv)
    src_path, dst_path = rest[0], rest[1]
    keep_every = int(rest[2]) if len(rest) > 2 else 2
    src = Database(src_path, async_writes=False)
    ids = src.all_node_ids()
    links = src.all_links()
    neighbor = (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED)
    closure_nodes = ({lk.from_id for lk in links if lk.type not in neighbor}
                     | {lk.to_id for lk in links if lk.type not in neighbor})
    keep = [i for k, i in enumerate(sorted(ids)) if k % keep_every == 0 or i in closure_nodes]
    keep_set = set(keep)
    nxt = {lk.from_id: lk for lk in links if lk.type in neighbor and lk.from_id < lk.to_id}
    out_links, seen_pairs = [], set()
    for lk in links:
        pair = (min(lk.from_id, lk.to_id), max(lk.from_id, lk.to_id))
        if (lk.type not in neighbor and lk.from_id in keep_set and lk.to_id in keep_set
                and pair not in seen_pairs):
            seen_pairs.add(pair)
            out_links.append(lk)
    for a in sorted(keep_set):
        lk = nxt.get(a)
        if lk is None:
            continue
        t_ab = torch.from_numpy(np.array(lk.transform, np.float32))
        info = lk.information
        b = lk.to_id
        merged = False
        while b not in keep_set and b in nxt:
            lk2 = nxt[b]
            t_ab = T.compose(t_ab, torch.from_numpy(np.array(lk2.transform, np.float32)))
            info = np.minimum(info, lk2.information)
            b = lk2.to_id
            merged = True
        if b in keep_set and b != a:
            out_links.append(Link(a, b, LINK_NEIGHBOR_MERGED if merged else lk.type,
                                  t_ab.numpy(), info))
    by_from: dict = {}
    for lk in out_links:
        by_from.setdefault(lk.from_id, {})[lk.to_id] = lk
    dst = Database(dst_path, async_writes=False)
    for i in keep:
        sig = src.load_signature(i)
        if sig is not None:
            sig.links = by_from.get(i, {})
            dst.save_signature(sig)
    dst.save_admin(params=src.load_admin().get("parameters"))
    dst.flush()
    print(f"reduced {len(ids)} -> {len(keep)} nodes, "
          f"{len(links)} -> {len(out_links)} links -> {dst_path}")
    src.close()
    dst.close()
    return len(keep)


# ----------------------------------------------------------- dataset tools


def _run_dataset_tool(ds, params, dev, out_db, max_frames, **kw):
    """``run_dataset`` over a reader, into a store at ``out_db`` when given."""
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset

    db = Database(out_db) if out_db else None
    out = run_dataset(iter(ds), ds.camera, params, db=db, max_frames=max_frames,
                      device=dev, **kw)
    if "ate_slam" in out:
        print(f"ATE RMSE (slam): {out['ate_slam']:.4f} m")
    if "ate_odom" in out:
        print(f"ATE RMSE (odom): {out['ate_odom']:.4f} m")
    if "kitti_t_err_pct" in out:
        print(f"KITTI t_err: {out['kitti_t_err_pct']:.2f}%  "
              f"r_err: {out['kitti_r_err_deg_per_m']:.4f} deg/m")
    if db:
        out["slam"].close()
        db.close()
    return out


def tool_rgbd_dataset(argv: List[str]):
    """TUM RGB-D benchmark (rtabmap-rgbd_dataset):
    ``rgbd_dataset [--Group/Name value ...] <path> [out.db] [max_frames]``."""
    from rtabmap_tpu_torch.datasets.readers import TumRgbdDataset
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    return _run_dataset_tool(TumRgbdDataset(rest[0]), params, dev,
                             rest[1] if len(rest) > 1 else None,
                             int(rest[2]) if len(rest) > 2 else 0)


def tool_kitti_dataset(argv: List[str]):
    """KITTI odometry benchmark (rtabmap-kitti_dataset), stereo, with the
    KITTI errors: ``kitti_dataset [--Group/Name value ...] <sequence dir>
    [poses.txt] [out.db] [max_frames]``."""
    from rtabmap_tpu_torch.datasets.readers import KittiDataset
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    ds = KittiDataset(rest[0], rest[1] if len(rest) > 1 else None)
    return _run_dataset_tool(ds, params, dev, rest[2] if len(rest) > 2 else None,
                             int(rest[3]) if len(rest) > 3 else 0,
                             stereo_model=ds.stereo, kitti_errors=True)


def tool_euroc_dataset(argv: List[str]):
    """EuRoC benchmark (rtabmap-euroc_dataset), stereo:
    ``euroc_dataset [--Group/Name value ...] <path> [out.db] [max_frames]``."""
    from rtabmap_tpu_torch.datasets.readers import EurocDataset
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    ds = EurocDataset(rest[0])
    return _run_dataset_tool(ds, params, dev, rest[1] if len(rest) > 1 else None,
                             int(rest[2]) if len(rest) > 2 else 0, stereo_model=ds.stereo)


def tool_cid_sims_dataset(argv: List[str]):
    """CID-SIMS ground-robot RGB-D benchmark (rtabmap-cid_sims_dataset):
    ``cid_sims_dataset [--gt] [--odom] [--imu 0|1] [--max_time_diff S]
    <path> [out.db] [max_frames]``: ``--gt`` reads groundtruth.txt,
    ``--odom`` the wheel odometry (re-seeds a lost odometry), ``--imu``
    imu.txt through the Madgwick (0) or complementary (1) filter."""
    from rtabmap_tpu_torch.datasets.readers import CidSimsDataset
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    use_gt = use_odom = False
    imu_filter = -1
    max_time_diff = 0.1
    pos = []
    i = 0
    while i < len(rest):
        a = rest[i]
        if a == "--gt":
            use_gt = True
        elif a == "--odom":
            use_odom = True
        elif a == "--imu":
            i += 1
            imu_filter = int(rest[i])
        elif a == "--max_time_diff":
            i += 1
            max_time_diff = float(rest[i])
        elif a != "--quiet":
            pos.append(a)
        i += 1
    ds = CidSimsDataset(pos[0], use_odom=use_odom, use_imu=imu_filter >= 0,
                        max_time_diff=max_time_diff)
    if not use_gt:
        ds.gt = []
    return _run_dataset_tool(ds, params, dev, pos[1] if len(pos) > 1 else None,
                             int(pos[2]) if len(pos) > 2 else 0,
                             imu_method="madgwick" if imu_filter != 1 else "complementary")


def tool_stereo_eval(argv: List[str]):
    """Stereo matching on a rectified pair (rtabmap-stereoEval):
    ``stereo_eval <left.png> <right.png> [max_disp=64]``; prints the
    sparse-LK and dense-SGBM disparity statistics and their agreement.
    Returns them, with the disparities and the SGBM's ms."""
    import time

    from rtabmap_tpu_torch.datasets.png import read_png
    from rtabmap_tpu_torch.ops import features as F
    from rtabmap_tpu_torch.ops import image as im
    from rtabmap_tpu_torch.ops import stereo as S

    dev, argv = _device(argv)

    def load(p):
        a = read_png(p)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return im.rgb_to_gray(t) if a.ndim == 3 else t.float() / 255.0

    left, right = load(argv[0]), load(argv[1])
    max_disp = int(argv[2]) if len(argv) > 2 else 64
    kps, _ = F.detect_and_describe(left, 256)
    disp, ok = S.lk_stereo_disparity(left, right, kps.uv, kps.valid,
                                     max_disparity=float(max_disp))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    dense_t = S.dense_sgbm_disparity(left, right, max_disparity=max_disp)
    sync()
    sgbm_ms = (time.perf_counter() - t0) * 1000.0
    dense, d_sparse, okn = dense_t.cpu().numpy(), disp.cpu().numpy(), ok.cpu().numpy()
    uv = kps.uv.cpu().numpy().astype(int)
    agree = []
    for i in np.where(okn)[0]:
        u, v = uv[i]
        if 0 <= v < dense.shape[0] and 0 <= u < dense.shape[1] and dense[v, u] > 0:
            agree.append(abs(dense[v, u] - d_sparse[i]))
    out = {
        "sparse_n": int(okn.sum()),
        "sparse_mean_disp": float(d_sparse[okn].mean()) if okn.any() else 0.0,
        "dense_density": float((dense > 0).mean()),
        "dense_mean_disp": float(dense[dense > 0].mean()) if (dense > 0).any() else 0.0,
        "sparse_dense_mad_px": float(np.mean(agree)) if agree else -1.0,
    }
    print(json.dumps(out, indent=2))
    return {**out, "sgbm_ms": sgbm_ms, "dense": dense, "sparse": d_sparse, "sparse_ok": okn,
            "uv": kps.uv.cpu().numpy()}


def tool_matcher(argv: List[str]):
    """Match two images and check their epipolar geometry (rtabmap-matcher):
    ``matcher <imgA.png> <imgB.png> [--Vis/... v]``. With a learned
    ``Kp/DetectorStrategy`` and ``Vis/CorNNType`` 6 the bundled
    attentional matcher gives the correspondences, else mutual NNDR.
    Prints and returns the features, matches and epipolar inliers."""
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.datasets.png import read_png
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.ops import epipolar as EP
    from rtabmap_tpu_torch.ops import image as im
    from rtabmap_tpu_torch.ops import matching as M
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv)
    params, rest = Parameters.parse_arguments(argv)
    max_kp = int(params["Vis/MaxFeatures"]) or 512

    def load(p):
        a = read_png(p)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return im.rgb_to_gray(t) if a.ndim == 3 else t.float() / 255.0

    ga, gb = load(rest[0]), load(rest[1])
    H, W = ga.shape
    cam = C.CameraModel.make(W, W, W / 2 - 0.5, H / 2 - 0.5, W, H)
    fe = FeatureExtractor(cam, params, max_kp=max_kp, device=dev)
    (fa, dfa), (fb, dfb) = fe.extract(ga), fe.extract(gb)
    if int(params["Vis/CorNNType"]) == 6 and dfa is not None:
        from rtabmap_tpu_torch.models.superglue import SuperGlueMatcher

        sgm = SuperGlueMatcher.distilled(device=dev)
        sc = torch.full((fa.uv.shape[0],), 0.5, dtype=torch.float32, device=dev)
        idx, okm, _conf = sgm.match(dfa, fa.uv, sc, fa.valid, dfb, fb.uv, sc, fb.valid,
                                    image_wh=(float(cam.width), float(cam.height)),
                                    threshold=float(params["PyMatcher/Threshold"]))
        m = M.Matches(idx=idx, dist=torch.zeros_like(sc), second=torch.zeros_like(sc),
                      valid=okm)
    else:
        m = M.match_mutual_nndr(fa.desc, fa.valid, fb.desc, fb.valid,
                                nndr=float(params["Vis/CorNNDR"]))
    nm = int(m.valid.sum())
    ok, _F, inl = EP.check_hypothesis(fa.uv, fb.uv[m.idx.long()], m.valid,
                                      torch.Generator().manual_seed(0))
    n_inl = int(inl.sum())
    print(f"features: {int(fa.valid.sum())} / {int(fb.valid.sum())}")
    print(f"mutual NNDR matches: {nm}")
    print(f"epipolar inliers: {n_inl} (geometry {'OK' if bool(ok) else 'REJECTED'})")
    return {"matches": nm, "inliers": n_inl, "ok": bool(ok)}


def tool_convert_model(argv: List[str]):
    """Convert pretrained checkpoints into the npz layout both packages load:
    ``convert_model superpoint <superpoint_v1.pt> <out.npz>``,
    ``convert_model superglue <superglue_indoor.pth> <out.npz>``,
    ``convert_model netvlad <ckpt.pt> <out.npz>``."""
    _, argv = _device(argv, resolve=False)
    if len(argv) < 3:
        print("usage: convert_model {superpoint|superglue|netvlad} <src> <out.npz>")
        return 1
    from rtabmap_tpu_torch.models import convert

    kind, src, out = argv[0], argv[1], argv[2]
    if kind == "superpoint":
        convert.convert_superpoint_file(src, out)
    elif kind == "superglue":
        from rtabmap_tpu_torch.models.superglue_official import save_params

        save_params(convert.convert_superglue(src), out)
    elif kind == "netvlad":
        np.savez(out, **convert.convert_netvlad(src))
    else:
        print(f"unknown model kind {kind!r}")
        return 1
    print(f"converted {kind} weights: {src} -> {out}")
    return 0


def tool_db_edit(argv: List[str]):
    """Map-store inspection and editing (the engine-facing surface of the
    reference's DatabaseViewer), with the twin's commands:

      db_edit <db> nodes                     list nodes (pose, weight, label)
      db_edit <db> links [type]              list links (optionally one type)
      db_edit <db> add_link <from> <to>      register and add a user closure
      db_edit <db> remove_link <from> <to>   delete a link and re-optimize
      db_edit <db> refine_links              refine every closure
      db_edit <db> set_label <id> <label>
      db_edit <db> dot <out.dot>             GraphViz export

    The edits load the store without a new session and close it again
    (persisting the edit). Unlike the twin's fixed 320x240 camera and 512
    words a node, the engine takes the store's own camera (``__camera__``,
    which its ``close()`` writes back) when the store has one, and the
    stored nodes' word count. Returns the listing or the edit's result."""
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.utils.logging import Statistics
    from rtabmap_tpu_torch.utils.params import Parameters

    dev, argv = _device(argv, resolve=False)
    params, rest = Parameters.parse_arguments(argv)
    path, cmd = rest[0], rest[1]
    db = Database(path)
    if cmd in ("nodes", "links"):
        if cmd == "nodes":
            out = []
            for sid in db.all_node_ids():
                s = db.load_signature(sid)
                if s is None:
                    continue
                p = np.asarray(s.pose)[:, 3]
                out.append({"id": sid, "map": s.map_id, "weight": s.weight, "label": s.label,
                            "xyz": [round(float(v), 3) for v in p]})
        else:
            links = db.all_links()
            if len(rest) > 2:
                links = [lk for lk in links if lk.type == int(rest[2])]
            out = [{"from": lk.from_id, "to": lk.to_id, "type": lk.type} for lk in links]
        print(json.dumps(out, indent=1))
        db.close()
        return out

    cam = C.CameraModel.make(*(db.load_admin()["parameters"].get("__camera__")
                               or _FIXED_CAMERA))
    first = next((s for s in map(db.load_signature, db.all_node_ids())
                  if s is not None and s.word_ids is not None), None)
    slam = Rtabmap.load(db, cam, params, new_session=False, device=dev,
                        words_per_frame=len(first.word_ids) if first is not None else 512)
    if cmd == "add_link":
        result = slam.add_user_link(int(rest[2]), int(rest[3]))
        print(f"add_link: {'accepted' if result else 'rejected'}")
    elif cmd == "remove_link":
        slam.memory.remove_link(int(rest[2]), int(rest[3]))
        slam._optimize(Statistics(), [])
        result = True
        print("removed")
    elif cmd == "refine_links":
        result = slam.refine_links()
        print(f"refined {result} links")
    elif cmd == "set_label":
        result = slam.set_label(int(rest[2]), rest[3])
        print(f"set_label: {result}")
    elif cmd == "dot":
        result = slam.generate_dot_graph(rest[2])
        print(f"wrote {result} edges -> {rest[2]}")
    else:
        db.close()
        raise SystemExit(f"unknown db_edit command {cmd}")
    slam.close()
    db.close()
    return result


def _later(name: str, slice_: str):
    def tool(argv: List[str]):
        raise NotImplementedError(f"the {name} tool is not ported yet; it comes with {slice_}")
    tool.__doc__ = f"Not ported yet: comes with {slice_}."
    return tool


_LATER = {
    "calibration": "the calibration slice",
    "cleanup_local_grids": "the tools slice",
    "console_app": "the tools slice",
    "data_recorder": "the sensor-input slice",
    "epipolar_geometry": "the tools slice",
    "extract_object": "the tools slice",
    "images_joiner": "the tools slice",
    "vocabulary_comparison": "the tools slice",
    "import_ref_db": "the reference-format store slice",
    "export_ref_db": "the reference-format store slice",
    "report": "the tools slice",
    "lidar_mapping": "the tools slice (python -m rtabmap_tpu_torch.tools.lidar_mapping runs it)",
    "wifi_mapping": "the tools slice",
    "fleet_demo": "the parallel slice",
}

TOOLS = {
    **{name: _later(name, slice_) for name, slice_ in _LATER.items()},
    "info": tool_info,
    "reprocess": tool_reprocess,
    "export": tool_export,
    "export_cloud": tool_export_cloud,
    "recovery": tool_recovery,
    "detect_more_loop_closures": tool_detect_more_loop_closures,
    "global_ba": tool_global_ba,
    "reduce_graph": tool_reduce_graph,
    "rgbd_dataset": tool_rgbd_dataset,
    "kitti_dataset": tool_kitti_dataset,
    "euroc_dataset": tool_euroc_dataset,
    "cid_sims_dataset": tool_cid_sims_dataset,
    "stereo_eval": tool_stereo_eval,
    "matcher": tool_matcher,
    "convert_model": tool_convert_model,
    "db_edit": tool_db_edit,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in TOOLS:
        print("usage: python -m rtabmap_tpu_torch.tools.cli <tool> [args...] [--device cpu]\n"
              f"tools: {', '.join(sorted(TOOLS))}")
        return 1
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    # the tools return their results for programmatic use, not exit codes
    _argv = sys.argv[1:]
    main(_argv)
    sys.exit(0 if _argv and _argv[0] in TOOLS else 1)

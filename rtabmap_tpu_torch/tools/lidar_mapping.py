"""LiDAR mapping: scan-to-map odometry, proximity closures, pose graph,
voxel map.

Port of ``rtabmap_tpu/tools/lidar_mapping.py``, the reference's
LidarMapping example (a Velodyne stream -> ICP odometry (Reg/Strategy=1,
OdometryF2M scan map) -> proximity closures by scan registration -> graph
optimization -> occupancy map). ``OdometryScanF2M`` gives the odometry
chain; each new node is registered (``register_scans``) with the first
older node, in node order, within ``proximity_radius``; the dense pose
graph is solved once at the end and the block-sparse voxel map assembled
at the optimized poses. Every state tensor lives on ``device``.

The run records, per frame, the wall time of odometry and of the
proximity registration (each ending in a device synchronize), the time of
the pose-graph solve and of the map, and how many 3-D nearest-neighbour
(K2) searches it asked for and how many destinations it prepared for them.

Usage: python -m rtabmap_tpu_torch.tools.lidar_mapping [n_frames]
       [--noise s] [--verbose] [--device cpu|cuda] [--n-azimuth 1800]
       [--n-rings 16] [--profile]

With no arguments it drives 150 frames of a VLP-16 (16 x 1800 points,
+-15 degrees) around ``lidar_trajectory(150, radius=2.0)`` in the box-room
simulator, with sensor-frame noise of sigma 0.01 m from
``numpy.random.default_rng(0)``, and a 16384-point local map, on the card. ``--profile`` traces the
second half of the frames with ``torch.profiler`` and prints the device
time by kernel and the device's busy share of that window's wall time.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import transform as TT
from rtabmap_tpu_torch.maps.voxel import VoxelOccupancyMap
from rtabmap_tpu_torch.odometry.scan_f2m import OdometryScanF2M
from rtabmap_tpu_torch.ops.icp import register_scans
from rtabmap_tpu_torch.optim import pose_graph as PG
from rtabmap_tpu_torch.utils import metrics
from rtabmap_tpu_torch.utils.logging import device_busy_us
from rtabmap_tpu_torch.utils.params import Parameters


# A local map that holds one whole keyframe of a VLP-16 scan voxel-filtered
# at 5 cm (about 7200 points): with the 2048-point map of OdomF2M/ScanMaxSize
# the oldest-first cull keeps only the lowest-index points of a keyframe, a
# ~100 degree azimuth sector, and the odometry loses frames.
VLP16_MAP_CAPACITY = 16384


def run_lidar_mapping(scans: Iterable[Tuple[object, object]],
                      params: Optional[Parameters] = None,
                      gt_poses: Optional[np.ndarray] = None,
                      proximity_radius: float = 1.0,
                      proximity_min_separation: int = 10,
                      voxel: float = 0.1, map_capacity: int = 2048,
                      verbose: bool = False, device: DeviceLike = None,
                      before_frame: Optional[Callable[[int], None]] = None,
                      after_frames: Optional[Callable[[], None]] = None) -> Dict:
    """Run the LiDAR SLAM pipeline over ``(points (N,3) sensor frame,
    valid (N,))`` scans (arrays or tensors). ``before_frame(i)`` is called
    before frame i and ``after_frames()`` after the last one, before the
    graph solve (e.g. around a profiler)."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    p = params or Parameters({"Icp/MaxCorrespondenceDistance": 0.5,
                              "Icp/Iterations": 15, "Icp/CorrespondenceRatio": 0.2})
    odom = OdometryScanF2M(params=p, map_capacity=map_capacity, scan_voxel=voxel / 2,
                           device=dev)
    max_corr = float(p["Icp/MaxCorrespondenceDistance"])
    icp_iters = int(p["Icp/Iterations"])

    node_poses: Dict[int, np.ndarray] = {}
    node_scans: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    ef, et, meas, infos = [], [], [], []
    closures: List[Tuple[int, int]] = []
    lost = 0
    searches = plans = 0
    odom_ms: List[float] = []
    reg_ms: List[float] = []
    frame_ms: List[float] = []

    for i, (pts, valid) in enumerate(scans):
        if before_frame is not None:
            before_frame(i)
        t0 = time.perf_counter()
        pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        pose, cov, info = odom.process(pts, valid)
        searches += info["nn_searches"]
        plans += info["nn_plans"]
        sync()
        t1 = time.perf_counter()
        odom_ms.append((t1 - t0) * 1e3)
        if pose is None:
            lost += 1
            reg_ms.append(0.0)
            frame_ms.append(odom_ms[-1])
            continue
        nid = len(node_poses)
        node_poses[nid] = pose.cpu().numpy()
        node_scans[nid] = (pts, valid)
        if nid > 0:
            t_ab = TT.relative(torch.as_tensor(node_poses[nid - 1], device=dev), pose)
            ef.append(nid - 1)
            et.append(nid)
            meas.append(t_ab.cpu().numpy())
            infos.append(np.eye(6) * 100.0)

        # proximity closure: the first older node within the radius; at
        # most one registration a frame, accepted or not
        cur_t = node_poses[nid][:, 3]
        for j in range(0, nid - proximity_min_separation):
            if np.linalg.norm(node_poses[j][:, 3] - cur_t) > proximity_radius:
                continue
            guess = TT.relative(torch.as_tensor(node_poses[j], device=dev),
                                torch.as_tensor(node_poses[nid], device=dev))
            sj = node_scans[j]
            res, icp_cov = register_scans(pts, valid, sj[0], sj[1], guess=guess,
                                          voxel=voxel / 2, max_corr_dist=max_corr,
                                          iters=icp_iters)
            searches += icp_iters + 1
            plans += 1
            if bool(res.valid):
                # res.transform maps the current scan into node j's frame
                ef.append(j)
                et.append(nid)
                meas.append(res.transform.cpu().numpy())
                infos.append(np.linalg.inv(icp_cov.cpu().numpy().astype(np.float64)
                                           + 1e-9 * np.eye(6)))
                closures.append((j, nid))
                if verbose:
                    print(f"loop closure {j} -> {nid} "
                          f"(ratio {float(res.correspondence_ratio):.2f})")
            break
        sync()
        t2 = time.perf_counter()
        reg_ms.append((t2 - t1) * 1e3)
        frame_ms.append((t2 - t0) * 1e3)
    if after_frames is not None:
        after_frames()

    out: Dict = {"nodes": len(node_poses), "closures": closures, "lost": lost,
                 "nn3d_searches": searches, "nn3d_plans": plans, "odom_ms": odom_ms,
                 "reg_ms": reg_ms, "frame_ms": frame_ms, "odometry": odom}
    if len(node_poses) < 2:
        out["poses"] = node_poses
        return out

    t0 = time.perf_counter()
    g = PG.make_graph(np.stack([node_poses[i] for i in sorted(node_poses)]),
                      np.asarray(ef, np.int64), np.asarray(et, np.int64),
                      np.stack(meas), np.stack(infos), device=dev)
    g_opt, _chi2 = PG.optimize(g, iters=20)
    solved = g_opt.poses.cpu().numpy()
    opt_poses = {i: solved[i] for i in sorted(node_poses)}
    t1 = time.perf_counter()

    vox = VoxelOccupancyMap(voxel=voxel, device=dev)
    for i in sorted(node_poses):
        vox.update(i, opt_poses[i], *node_scans[i])
    occ_xyz, _, _ = vox.occupied_voxels()
    t2 = time.perf_counter()
    out.update(poses=opt_poses, odom_poses=node_poses, occupied_voxels=int(occ_xyz.shape[0]),
               voxel_map=vox, graph=g_opt, graph_ms=(t1 - t0) * 1e3, map_ms=(t2 - t1) * 1e3)

    if gt_poses is not None:
        gt = np.asarray(gt_poses)
        est = np.stack([opt_poses[i] for i in sorted(opt_poses)])
        n = min(est.shape[0], len(gt))
        out["ate_slam"] = metrics.ate_rmse(est[:n], gt[:n])
        odo = np.stack([node_poses[i] for i in sorted(node_poses)])
        out["ate_odom"] = metrics.ate_rmse(odo[:n], gt[:n])
    return out


def run_synthetic(n_frames: int = 40, radius: float = 2.0, n_azimuth: int = 180,
                  n_rings: int = 6, noise: float = 0.0, verbose: bool = False,
                  device: DeviceLike = None) -> Dict:
    """Drive the pipeline on the analytic box-room LiDAR simulator; world-
    frame noise comes from a ``torch.Generator`` seeded with 0."""
    dev = resolve_device(device)
    poses = S.lidar_trajectory(n_frames, radius=radius)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scans = (S.lidar_scan(poses[i], n_azimuth=n_azimuth, n_rings=n_rings, noise=noise,
                          generator=gen, device=dev) for i in range(n_frames))
    return run_lidar_mapping(scans, gt_poses=poses, verbose=verbose, device=dev)


def sensor_sequence(n_frames: int = 150, n_azimuth: int = S.VLP16_AZIMUTH,
                    n_rings: int = S.VLP16_RINGS, noise: float = 0.01,
                    device: DeviceLike = None) -> Tuple[np.ndarray, Iterator]:
    """(ground-truth poses, scans) of a VLP-16-like sensor (+-15 degrees)
    circling the box room: ``lidar_trajectory(n_frames, radius=2.0)``,
    noise of sigma ``noise`` added in the sensor frame from
    ``numpy.random.default_rng(0)``, frame by frame (the sequence that
    ``scripts/jax_lidar_mapping.py`` gives the JAX package)."""
    dev = resolve_device(device)
    poses = S.lidar_trajectory(n_frames, radius=2.0)
    rng = np.random.default_rng(0)

    def scans():
        for pose in poses:
            pts, valid = S.lidar_scan(pose, n_azimuth=n_azimuth, n_rings=n_rings,
                                      elev_span=S.VLP16_ELEV_SPAN, device=dev)
            eps = torch.from_numpy(S.sensor_noise(rng, pts.shape[0], noise)).to(dev)
            yield pts + eps, valid

    return poses, scans()


def summary(out: Dict) -> Dict:
    """The run's numbers as JSON-ready values."""
    frame = np.asarray(out["frame_ms"])
    res = {k: out[k] for k in ("nodes", "lost", "nn3d_searches", "nn3d_plans",
                               "occupied_voxels",
                               "ate_slam", "ate_odom", "graph_ms", "map_ms") if k in out}
    res.update(closures=len(out["closures"]),
               frame_ms_median=float(np.median(frame)),
               frame_ms_p90=float(np.percentile(frame, 90)),
               odom_ms_median=float(np.median(out["odom_ms"])),
               reg_ms_median=float(np.median(out["reg_ms"])))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", type=int, nargs="?", default=150)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--n-azimuth", type=int, default=S.VLP16_AZIMUTH)
    ap.add_argument("--n-rings", type=int, default=S.VLP16_RINGS)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gt, scans = sensor_sequence(args.n_frames, args.n_azimuth, args.n_rings,
                                args.noise, device=dev)
    prof, window = None, {}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def before_frame(i):
            if i == args.n_frames // 2:
                prof.__enter__()  # the profiler's start-up stays out of the window
                window["t0"] = time.perf_counter()

        def after_frames():
            # every frame ended in a synchronize: the window's device work is done
            window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.__exit__(None, None, None)
    out = run_lidar_mapping(scans, gt_poses=gt, verbose=args.verbose, device=dev,
                            map_capacity=VLP16_MAP_CAPACITY,
                            before_frame=before_frame if prof else None,
                            after_frames=after_frames if prof else None)
    res = summary(out)
    if prof is not None:
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
        busy_us, n_ops = device_busy_us(prof)
        frames = args.n_frames - args.n_frames // 2
        res["profile"] = {"frames": frames, "wall_ms": window["wall_us"] / 1e3,
                          "device_busy_ms": busy_us / 1e3,
                          "device_busy_share": busy_us / window["wall_us"],
                          "device_ops_per_frame": n_ops / frames}
    print(json.dumps({"device": str(dev), "frames": args.n_frames,
                      "points": args.n_azimuth * args.n_rings, **res}))


if __name__ == "__main__":
    main()

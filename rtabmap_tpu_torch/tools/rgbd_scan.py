"""RGB-D + LiDAR SLAM: an RGB-D camera and a VLP-16 through
``Rtabmap.process(scan=...)``, the usual mobile-robot rig of RTAB-Map.

Renders ``rgbd_laps``' RGB-D sequences and, at every frame, a 16-ring
LiDAR rigidly mounted at the camera (its x axis along the optical axis,
z up: the ``maps/grids.BASE_T_OPTICAL`` base frame) in the same room
(``datasets/synthetic.lidar_scan`` with the room's half extents permuted
to the LiDAR's z-up axes, no pillars, the VLP-16's +-15 degree fan). The
ranges go into 1206-byte VLP-16 packets (``sensors/lidar.encode_packet``:
2 mm range and 0.01 degree azimuth steps) and come back as a scan through
``LidarVLP16``; the tool turns the points into the camera (node) frame
on the device, voxel-filters the scan at ``SCAN_VOXEL`` (the reference's
``Mem/LaserScanVoxelSize``) and builds the node's ``LocalGrid`` from the
points within ``GRID_HEIGHT`` of the LiDAR (the reference's
``Grid/MaxObstacleHeight``; voxel filter, k-NN normals, every point in
range);
``run_dataset`` hands both to ``Rtabmap.process``. Runs:

- ``parity``: ``tests/test_slam_e2e.py``'s 58 frames at 320x240, 16 x 225
  scans, with ``RGBD/NeighborLinkRefining``, ``VhEp/Enabled``,
  ``Rtabmap/CreateIntermediateNodes`` and ``Rtabmap/DetectionRate`` 0.5
  (stamps 1 s apart: every other frame is an intermediate node);
- ``full``: ``rgbd_laps``' two 60-frame laps at 640x480 with 16 x 1800 =
  28800-point scans, refining and VhEp on, ``Rtabmap/DetectionRate`` 0,
  into a map store with the scans and grids;
- ``localization``: ``Rtabmap.load`` of that store with
  ``Mem/IncrementalMemory`` false and ``RGBD/ProximityGlobalScanMap``
  true in place of the path proximity (``RGBD/LocalRadius`` 0), 20 frames of ``rgbd_sessions``' localization lap, the odometry
  restarted at the identity and the start given on the map
  (``set_initial_pose``, 0.25 m and 0.1 rad off): the square hall's scans
  repeat under a quarter turn, so a scan alone cannot tell the walls apart.

Each run prints one JSON line: loops, proximity links by kind (visual,
scan ICP), neighbour links refined, epipolar checks, intermediate nodes,
lost frames, the map's and the odometry's ATE, frame, ``process`` and
engine stage ms,
and the assembled ``OccupancyGrid``'s occupied cells and their share
within two cells of a wall; localization adds the localized frames and
their errors, the global scan map's rows and how often it was registered.
``scripts/jax_rgbd_scan.py`` runs the parity sequence through the JAX
package; ``chip_smoke.py`` holds the port's runs on the card to it and to
the ground truth.

Usage: python -m rtabmap_tpu_torch.tools.rgbd_scan [--device cpu]
       [--run parity|full|full+localization] [--frames N] [--seed S]
       [--size W H] [--n-azimuth A]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.laser_scan import LaserScan, ScanFormat, make_scan
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.datasets.readers import Frame
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.maps import grids as G
from rtabmap_tpu_torch.ops import cloud as CL
from rtabmap_tpu_torch.memory.memory import LINK_LOCAL_SPACE_CLOSURE
from rtabmap_tpu_torch.sensors import lidar as L
from rtabmap_tpu_torch.tools import rgbd_sessions as RS
from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
from rtabmap_tpu_torch.utils.params import Parameters

RUNS = ("parity", "full", "full+localization")
# the engine's stage timings the summary reads (median and p90 a frame)
STAGE_TIMINGS = ("Timing/Neighbor link refining/ms", "Timing/Proximity by space/ms",
                 "Timing/Hypotheses validation/ms", "Timing/Map optimization/ms",
                 "Timing/Memory update/ms")
AZIMUTHS = {"parity": 225, "full": S.VLP16_AZIMUTH}
# The occupancy grid's cell (the reference's Grid/CellSize): 10 cm for the
# 16 x 16 m hall, whose walls the LiDAR sees 6.5-9.5 m away, where the map's
# heading error at the end of lap 2 (up to 0.34 degree, measured: PERF.md)
# moves a wall by up to 5 cm.
GRID_CELL = 0.1
# The scan's voxel filter before it reaches the engine (the reference's
# Mem/LaserScanVoxelSize): the engine's ICP takes its normals from the 8
# nearest points at 5 cm, and a VLP-16's rings hit walls 6.5-9.5 m away
# 23-33 cm apart, so at 5 cm those 8 points lie along one ring, the normals
# are ill-defined and a refined link drifts about 4 cm sideways (measured:
# PERF.md). At 10 cm the neighbourhoods span two rings.
SCAN_VOXEL = 0.1
# The local grid takes the points within this height of the LiDAR (the
# reference's Grid/MaxObstacleHeight): the grid lays each point's base-frame
# (x, y) into the map at the node's pose, so a node tilted by t degrees
# moves a point h metres up or down by h sin(t) across the floor: lap 2's
# camera is tilted 2 degrees and the walls are seen 2.5 m up and down.
GRID_HEIGHT = 0.5
# the engine's parameters of each run on top of the defaults
RUN_PARAMS = {
    "parity": {"RGBD/NeighborLinkRefining": True, "VhEp/Enabled": True,
               "Rtabmap/CreateIntermediateNodes": True, "Rtabmap/DetectionRate": 0.5},
    "full": {"RGBD/NeighborLinkRefining": True, "VhEp/Enabled": True,
             "Rtabmap/DetectionRate": 0},
    # the global scan map takes the place of the proximity detection along
    # local paths (the reference's RGBD/ProximityGlobalScanMap); the engine
    # has no RGBD/ProximityBySpace switch, so RGBD/LocalRadius 0 turns it off
    "localization": {"RGBD/NeighborLinkRefining": True, "VhEp/Enabled": True,
                     "Rtabmap/DetectionRate": 0, "Mem/IncrementalMemory": False,
                     "RGBD/ProximityGlobalScanMap": True, "RGBD/LocalRadius": 0.0},
}
# the start given on the map in localization: (x, z) 0.2 / -0.15 m off in
# the horizontal plane, 0.1 rad about the vertical (the scans fix both;
# nothing in a room of vertical walls fixes a vertical offset)
START_OFFSET = (0.2, 0.0, -0.15, 0.0, 0.1, 0.0)

# LiDAR world frame (z up) in the renderer's world (y down is "up" = -y):
# x_L = x_W, y_L = z_W, z_L = -y_W
R_WL = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)
# the base (= LiDAR) frame's axes in the camera's optical frame
R_CB = np.asarray(G.BASE_T_OPTICAL, np.float32)[:, :3].T


def lidar_pose(cam_pose_wc: np.ndarray) -> np.ndarray:
    """The LiDAR's pose in the LiDAR world frame for a camera pose in the
    renderer's world: the same origin, the base frame's axes."""
    P = np.asarray(cam_pose_wc, np.float32)
    R_ws = P[:, :3] @ R_CB
    return np.concatenate([R_WL.T @ R_ws, (R_WL.T @ P[:, 3])[:, None]], axis=1)


def lidar_room(world_half) -> Tuple[float, float, float]:
    """The renderer's room half extents on the LiDAR world's axes."""
    hx, hy, hz = world_half
    return (hx, hz, hy)


def packet_fields(ranges: np.ndarray, intensity: int = 100) -> List[Tuple]:
    """One revolution of ``lidar_scan`` ranges (n_azimuth, 16), azimuth-major
    and ring-minor in its order (azimuth counter-clockwise from +x, rings
    from -15 to +15 degrees; 0 = no return), as the (azimuths (12,),
    distances (12, 32), intensities (12, 32)) of each VLP-16 packet: firings
    sorted by the packet's azimuth (clockwise from +y, 90 degrees minus the
    simulator's), lasers in the VLP-16 firing order, two firings a block,
    the last packet filled with empty firings (their azimuths go on by the
    step and stop short of 360 degrees, so the decoder sees the revolution
    end at the next packet). ``n_azimuth`` must divide 36000 (whole
    hundredths of a degree)."""
    n_az = ranges.shape[0]
    if 36000 % n_az:
        raise ValueError(f"{n_az} azimuths do not divide 36000")
    step = 36000 // n_az
    cdeg = (9000 - np.arange(n_az) * step) % 36000          # packet azimuth, 0.01 deg
    order = np.argsort(cdeg, kind="stable")
    ring_of_channel = ((L.ELEVATIONS_DEG + 15) // 2).astype(np.int64)
    dist = ranges[order][:, ring_of_channel]                 # (firings, 16)
    inten = np.where(dist > 0, intensity, 0)
    cdeg = cdeg[order]
    pad = (-n_az) % (2 * L.BLOCKS_PER_PACKET)
    if pad:
        cdeg = np.concatenate([cdeg, np.minimum(cdeg[-1] + step * np.arange(1, pad + 1),
                                                35999)])
        dist = np.concatenate([dist, np.zeros((pad, 16), dist.dtype)])
        inten = np.concatenate([inten, np.zeros((pad, 16), inten.dtype)])
    n_packets = cdeg.shape[0] // (2 * L.BLOCKS_PER_PACKET)
    blk = lambda a: a.reshape(n_packets, L.BLOCKS_PER_PACKET, 32)  # noqa: E731
    az = cdeg[0::2].reshape(n_packets, L.BLOCKS_PER_PACKET) / 100.0
    return list(zip(az, blk(dist), blk(inten)))


def vlp16_scan(cam_pose_wc: np.ndarray, world_half, n_azimuth: int,
               device: torch.device) -> Tuple[LaserScan, torch.Tensor, torch.Tensor]:
    """The frame's VLP-16 scan through packets: (the scan in the node
    (camera) frame with its SCAN_VOXEL mask, the points in the base frame
    and their range mask)."""
    pts, valid = S.lidar_scan(lidar_pose(cam_pose_wc), n_azimuth=n_azimuth,
                              n_rings=S.VLP16_RINGS, room_half=lidar_room(world_half),
                              pillars=(), elev_span=S.VLP16_ELEV_SPAN, device=device)
    ranges = torch.where(valid, torch.linalg.norm(pts, dim=-1), 0.0)
    packets = [L.encode_packet(*f) for f in packet_fields(
        ranges.reshape(n_azimuth, S.VLP16_RINGS).cpu().numpy())]
    raw = next(iter(L.LidarVLP16(packets, device=device)))
    xyz_b = raw.xyz()
    xyz_c = xyz_b @ torch.as_tensor(R_CB.T, device=device)   # p_c = R_CB p_b
    scan = make_scan(torch.cat([xyz_c, raw.data[:, 3:4]], dim=-1), ScanFormat.XYZI,
                     valid=CL.voxel_filter(xyz_c, raw.valid, SCAN_VOXEL),
                     max_range=raw.max_range, device=device)
    return scan, xyz_b, raw.valid


def scan_grid(xyz_b: torch.Tensor, valid: torch.Tensor) -> G.LocalGrid:
    """The node's local grid from its base-frame points within GRID_HEIGHT
    of the LiDAR, voxel-filtered at SCAN_VOXEL (normals from two rings, as
    for the ICP), every point in range."""
    gv = CL.voxel_filter(xyz_b, valid & (xyz_b[:, 2].abs() < GRID_HEIGHT), SCAN_VOXEL)
    normals, _ = CL.estimate_normals(xyz_b, gv, k=8)
    return G.local_grid_from_cloud(xyz_b, gv, normals, cell_size=GRID_CELL,
                                   max_points=xyz_b.shape[0])


def sensor_scan(cam_pose_wc: np.ndarray, world_half, n_azimuth: int,
                device: torch.device) -> Tuple[LaserScan, G.LocalGrid]:
    """The frame's scan in the node frame and its local grid."""
    scan, xyz_b, in_range = vlp16_scan(cam_pose_wc, world_half, n_azimuth, device)
    return scan, scan_grid(xyz_b, in_range)


def _camera(name: str, size: Optional[Tuple[int, int]]):
    """The sequence's spec and camera, rendered at ``size`` (fx scaled) when
    given."""
    spec = sequence_spec(name)
    if size is None:
        return spec, C.CameraModel.make(spec["f"], spec["f"], *spec["c"], *spec["size"])
    f = spec["f"] * size[0] / spec["size"][0]
    return spec, C.CameraModel.make(f, f, (size[0] - 1) / 2.0, (size[1] - 1) / 2.0, *size)


def frames(poses: np.ndarray, cam, world_half, n_azimuth: int,
           device: torch.device) -> Iterator[Frame]:
    """Rendered RGB-D frames with their scans and grids, 1 s apart."""
    grays, depths = S.render_sequence(poses, cam, S.World(world_half, S.DEFAULT_WORLD.seed),
                                      device=device)
    for i, (pose, gray, depth) in enumerate(zip(poses, grays, depths)):
        scan, grid = sensor_scan(pose, world_half, n_azimuth, device)
        yield Frame(stamp=float(i), gray=gray, depth=depth, gt_pose=pose, scan=scan,
                    grid=grid)


def wall_share(occ: np.ndarray, grid: G.OccupancyGrid, to_world, world_half) -> float:
    """Share of the occupied cells whose centre, carried into the world by
    ``to_world`` ((N,3) map points -> world points), lies within two cells
    of a wall of the room."""
    cy, cx = np.nonzero(occ == 100)
    if cx.size == 0:
        return 0.0
    pts = np.zeros((cx.size, 3))
    a, b = grid.plane
    pts[:, a] = grid.origin + (cx + 0.5) * grid.cell
    pts[:, b] = grid.origin + (cy + 0.5) * grid.cell
    w = to_world(pts)
    hx, _, hz = world_half
    d = np.minimum(np.abs(hx - np.abs(w[:, 0])), np.abs(hz - np.abs(w[:, 2])))
    return float(np.mean(d <= 2 * grid.cell))


def map_to_world(slam) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) carrying the map frame onto the ground truth's: the mean over
    the nodes with a ground truth of gt_i inv(opt_i), the rotations'
    chordal mean. (Aligning by positions alone, as the ATE does, leaves the
    map's heading to the positions' centimetres over the laps' 1.5 m
    radius: about half a degree, a cell at the walls 8 m away.)"""
    opt = slam.get_optimized_poses()
    ids = [i for i in sorted(opt) if (s := slam.memory.get(i)) is not None
           and s.gt_pose is not None]
    rel = [T.np_compose(slam.memory.get(i).gt_pose, T.np_inverse(opt[i])) for i in ids]
    U, _, Vt = np.linalg.svd(sum(r[:, :3] for r in rel))
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    t = np.mean([slam.memory.get(i).gt_pose[:, 3] - R @ np.asarray(opt[i])[:, 3]
                 for i in ids], axis=0)
    return R, t


def assembled_grid(slam, world_half, device) -> Dict:
    """The nodes' local grids assembled over the optimized poses: occupied
    and free cells, and the occupied share near a wall (``map_to_world``)."""
    opt = slam.get_optimized_poses()
    occ = G.OccupancyGrid(cell_size=GRID_CELL, up_axis=1, device=device)
    T_cb = np.concatenate([R_CB, np.zeros((3, 1), np.float32)], axis=1)
    poses = {}
    for i, s in slam.memory.signatures.items():
        if s.grid is not None and i in opt:
            poses[i] = np.asarray(T.np_compose(opt[i], T_cb), np.float32)
            occ.update(i, poses[i], s.grid)
    occ.assemble(poses)
    grid = occ.to_occupancy()
    R, t = map_to_world(slam)
    return {"grid_nodes": len(poses), "occupied_cells": int((grid == 100).sum()),
            "free_cells": int((grid == 0).sum()),
            "occupied_near_wall": wall_share(grid, occ, lambda p: p @ R.T + t, world_half)}


def counts(slam, run: Dict) -> Dict:
    """Loops, links, refinings, epipolar checks and nodes of a run, read
    from the engine's statistics and signatures (plain Python, so the JAX
    package's engine reads alike). The ATE is the map's: every node with a
    ground truth (intermediate nodes carry none) at its optimized pose."""
    hist = slam.stats_history
    mem = slam.memory
    ate, ate_nodes = RS.map_ate(slam)
    scan_links = int(sum(s.get("Proximity/Space detections added icp multi/") for s in hist
                         if s.get("Proximity/Space links added/") > 0))
    space_links = sum(1 for i, s in mem.signatures.items() for j, lk in s.links.items()
                      if i < j and lk.type == LINK_LOCAL_SPACE_CLOSURE)
    closures = [s for s in hist if s.loop_closure_id > 0]
    intermediate = sum(1 for s in mem.signatures.values() if s.weight < 0)
    return {"frames": run["frames"], "lost": run["lost"], "loops": run["loops"],
            "proximity_visual": space_links - scan_links, "proximity_scan": scan_links,
            "refined": int(sum(s.get("NeighborLinkRefining/Accepted/") for s in hist)),
            "refine_attempts": sum("NeighborLinkRefining/Accepted/" in s.data for s in hist),
            "epipolar_checks": sum("Loop/Epipolar pairs/" in s.data for s in hist),
            "accepted_closures": len(closures),
            "epipolar_on_accepted": sum("Loop/Epipolar pairs/" in s.data for s in closures),
            "intermediate_nodes": intermediate, "nodes": len(mem.signatures),
            "map_ate": ate, "map_ate_nodes": ate_nodes, "ate_odom": run.get("ate_odom"),
            "n_words": mem.vocab.n_words,
            "quantize_calls": sum("TimingMem/Add new words/ms" in s.data for s in hist)
            + intermediate}


def summary(name: str, run: Dict, poses: np.ndarray, world_half, device) -> Dict:
    """``counts``, the host times and the run's map: the assembled grid
    when mapping; the localized frames, their errors and the global scan
    map when localizing."""
    slam = run["slam"]
    hist = slam.stats_history
    frame_ms = np.add(run["odom_ms"], run["process_ms"]) + np.asarray(run["extract_ms"])
    out = {"run": name, **counts(slam, run), "frame_ms": RS._ms(frame_ms),
           "process_ms": RS._ms(run["process_ms"]), "odom_ms": RS._ms(run["odom_ms"]),
           "stage_ms": {k.split("/")[1]: RS._ms([s.get(k) for s in hist if k in s.data])
                        for k in STAGE_TIMINGS}}
    if slam.memory.incremental:
        out.update(assembled_grid(slam, world_half, device))
        return out
    errs = RS.localization_errors(slam, hist, poses)
    by_scan = [(s, p) for s, p in zip(hist, poses)
               if s.get("Proximity/Space detections added icp global/") > 0]
    scan_errs = RS.localization_errors(slam, [s for s, _ in by_scan], [p for _, p in by_scan])
    stat = lambda f, e: float(f(e)) if e else float("nan")  # noqa: E731
    cache = slam._global_scan_cache
    out.update(localized=len(errs),
               loc_err_m={"min": stat(min, errs), "median": stat(np.median, errs),
                          "max": stat(max, errs)},
               scan_localized=len(scan_errs), scan_loc_err_max_m=stat(max, scan_errs),
               global_scan_calls=slam.global_scan_calls,
               global_map_rows=0 if cache is None else int(cache[1].shape[0]),
               global_map_valid=0 if cache is None else int(cache[2].sum()))
    return out


def run_mapping(name: str, device: DeviceLike = None, frames_cut: int = 0, seed: int = 0,
                db=None, size: Optional[Tuple[int, int]] = None,
                n_azimuth: int = 0) -> Tuple[Dict, Dict]:
    """One mapping run (``parity`` or ``full``) on ``device`` (None = the
    CUDA card), into ``db`` when given. Returns (summary, raw run)."""
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset

    dev = resolve_device(device)
    spec, cam = _camera(name, size)
    poses = spec["poses"][: frames_cut or None]
    run = run_dataset(frames(poses, cam, spec["world"], n_azimuth or AZIMUTHS[name], dev),
                      cam, Parameters(RUN_PARAMS[name]), max_kp=spec["max_kp"],
                      node_capacity=spec["node_capacity"], db=db, verbose=False,
                      device=dev, seed=seed)
    return summary(name, run, poses, spec["world"], dev), run


def run_localization(db, device: DeviceLike = None, frames_cut: int = 0, seed: int = 0,
                     size: Optional[Tuple[int, int]] = None, n_azimuth: int = 0,
                     saved_scans: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None
                     ) -> Tuple[Dict, Dict]:
    """Localize in the ``full`` run's store ``db``; with ``saved_scans``
    ({node id: (data, valid)} as the mapping run held them), checks that
    every stored scan reads back equal. Returns (summary, raw run)."""
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset

    dev = resolve_device(device)
    spec, cam = _camera("full", size)
    p = Parameters(RUN_PARAMS["localization"])
    slam = Rtabmap.load(db, cam, p, node_capacity=spec["node_capacity"],
                        words_per_frame=spec["max_kp"], seed=42 + seed, device=dev)
    read_back = equal = 0
    for i, (data, valid) in (saved_scans or {}).items():
        s = slam.memory.get(i).scan
        read_back += 1
        equal += int(np.array_equal(s.data.cpu().numpy(), data)
                     and np.array_equal(s.valid.cpu().numpy(), valid))
    poses = RS.session_poses("localization")[: frames_cut or None]
    # the start on the map: the ground truth in the mapping run's first
    # camera frame (its odometry origin), moved by START_OFFSET
    start = T.np_compose(T.np_relative(spec["poses"][0], poses[0]),
                         T.se3_exp(torch.tensor(START_OFFSET)).numpy())
    slam.set_initial_pose(np.asarray(start, np.float32))
    run = run_dataset(frames(poses, cam, spec["world"], n_azimuth or AZIMUTHS["full"], dev),
                      cam, p, max_kp=spec["max_kp"], node_capacity=spec["node_capacity"],
                      verbose=False, device=dev, seed=seed, slam=slam)
    out = summary("localization", run, poses, spec["world"], dev)
    out.update(scans_read_back=read_back, scans_equal=equal)
    return out, run


def host_scans(slam) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{node id: (scan data, mask)} on the host, of every node with a scan."""
    return {i: (s.scan.data.cpu().numpy(), s.scan.valid.cpu().numpy())
            for i, s in slam.memory.signatures.items() if s.scan is not None}


def main(argv=None):
    from rtabmap_tpu_torch.memory.db import Database

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--run", default="full+localization", choices=RUNS)
    ap.add_argument("--frames", type=int, default=0, help="cut each run (0 = whole)")
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC generators")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("W", "H"))
    ap.add_argument("--n-azimuth", type=int, default=0, help="LiDAR azimuths (0 = the run's)")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, frames_cut=args.frames, seed=args.seed,
              size=tuple(args.size) if args.size else None, n_azimuth=args.n_azimuth)
    if args.run == "parity":
        print(json.dumps(run_mapping("parity", **kw)[0]), flush=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        db = Database(os.path.join(tmp, "map.db"))
        try:
            res, run = run_mapping("full", db=db, **kw)
            saved = host_scans(run["slam"])
            run["slam"].close()
        finally:
            db.close()
        print(json.dumps(res), flush=True)
        if args.run == "full+localization":
            db = Database(os.path.join(tmp, "map.db"))
            try:
                res, _ = run_localization(db, saved_scans=saved, **kw)
            finally:
                db.close()
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

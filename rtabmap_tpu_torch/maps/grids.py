"""Occupancy mapping: per-node local grids and their global assembly.

Port of ``rtabmap_tpu/maps/grids.py`` (the reference's ``LocalGridMaker``
and its ``OccupancyGrid`` / ``CloudMap`` global maps). A local grid is
one batch of tensor operations over the node's cloud: ground/obstacle
segmentation by normal angle and height, empty cells by fixed-step
sampling along every ray, each cell set cut to a fixed capacity in the
twin's valid-first order (``core/laser_scan.valid_first``). The global
grid is a log-odds canvas on the device updated by one scatter-add a cell
set, re-assembled from the cached local grids when the poses move.

Cell indices divide by a tensor (a host scalar divisor becomes a multiply
by its reciprocal on the card, which is not the twin's division). The
scatter-adds add equal deltas, so their order changes nothing but the
last bit of a cell hit three or more times.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.laser_scan import valid_first
from rtabmap_tpu_torch.device import DeviceLike, resolve_device, to_numpy
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T


class LocalGrid(NamedTuple):
    """Per-node cells in the node's local (base) frame, fixed capacity,
    masked: tensors on one device, or numpy arrays as a store returns them."""

    ground: torch.Tensor      # (Ng,2) xy cells (metres)
    ground_valid: torch.Tensor
    obstacles: torch.Tensor   # (No,2)
    obstacles_valid: torch.Tensor
    empty: torch.Tensor       # (Ne,2) ray-traced free cells
    empty_valid: torch.Tensor

    def to(self, device) -> "LocalGrid":
        """The same grid as tensors on ``device``."""
        return LocalGrid(*(v.to(device) if isinstance(v, torch.Tensor)
                           else torch.as_tensor(np.asarray(v), device=device) for v in self))


def _hash_keep_first(h: torch.Tensor, ok: torch.Tensor, hash_size: int) -> torch.Tensor:
    """ok & (the row is the first ok row of its hash cell)."""
    n = h.shape[0]
    order = torch.arange(n, dtype=torch.int64, device=h.device)
    owner = torch.full((hash_size,), n, dtype=torch.int64, device=h.device)
    owner = owner.scatter_reduce(0, h, torch.where(ok, order, n), "amin")
    return ok & (owner[h] == order)


def local_grid_from_cloud(pts: torch.Tensor, valid: torch.Tensor, normals: torch.Tensor,
                          cell_size: float = 0.05, max_ground_angle: float = 0.785,
                          max_ground_height: float = 0.15, max_range: float = 8.0,
                          max_points: int = 2048, ray_steps: int = 64) -> LocalGrid:
    """Segment a base-frame cloud (z up) into ground/obstacle cells and
    ray-trace empty cells toward each measured point (reference:
    LocalGridMaker::createLocalMap)."""
    dev = pts.device
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    cosang = (normals * up[None]).sum(-1).abs()
    is_ground = (valid & (cosang > float(np.cos(np.float32(max_ground_angle))))
                 & (pts[:, 2].abs() < max_ground_height))
    in_range = valid & (torch.linalg.norm(pts[:, :2], dim=-1) < max_range)
    is_obstacle = in_range & ~is_ground
    cell = torch.tensor(cell_size, dtype=torch.float32, device=dev)

    def take(mask, cap):
        idx = valid_first(mask, cap)
        return pts[idx, :2], mask[idx]

    g_xy, g_ok = take(is_ground & in_range, max_points)
    o_xy, o_ok = take(is_obstacle, max_points)
    # ray tracing: samples from the origin toward each point in range; the
    # cells strictly before the hit are empty
    tgt, tgt_ok = take(in_range, max_points)
    steps = torch.linspace(0.05, 0.95, ray_steps, device=dev)
    e_xy = (tgt[:, None, :] * steps[None, :, None]).reshape(-1, 2)
    e_ok = tgt_ok.repeat_interleave(ray_steps)
    cells = torch.floor(e_xy / cell).to(torch.int32).to(torch.int64)
    h = ((cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663)) & ((1 << 16) - 1)
    e_ok = _hash_keep_first(h, e_ok, 1 << 16)
    keep = valid_first(e_ok, max_points)
    snap = lambda xy: (torch.floor(xy / cell) + 0.5) * cell  # noqa: E731
    return LocalGrid(ground=snap(g_xy), ground_valid=g_ok,
                     obstacles=snap(o_xy), obstacles_valid=o_ok,
                     empty=snap(e_xy[keep]), empty_valid=e_ok[keep])


# optical (x right, y down, z forward) -> base (x forward, y left, z up)
BASE_T_OPTICAL = ((0.0, 0.0, 1.0, 0.0), (-1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0))


def local_grid_from_depth(depth: torch.Tensor, cam: C.CameraModel, base_T_cam=None,
                          cell_size: float = 0.05, decimation: int = 4, **kw) -> LocalGrid:
    """Depth image -> local grid (the camera's optical frame rotated to
    base: x forward, y left, z up, unless ``base_T_cam`` is given)."""
    from rtabmap_tpu_torch.ops import cloud as CL

    dev = depth.device
    pts, ok = CL.cloud_from_depth(depth, cam, decimation=decimation)
    s = 1.0 / decimation
    small = cam._replace(fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s,
                         width=int(cam.width * s), height=int(cam.height * s))
    nrm, _ = CL.normals_from_depth(depth[::decimation, ::decimation], small)
    B = torch.as_tensor(np.asarray(BASE_T_OPTICAL if base_T_cam is None else base_T_cam,
                                   np.float32), device=dev)
    pts_b = T.apply(B[None], pts[None])[0]
    nrm_b = torch.einsum("ij,nj->ni", T.rotation(B), nrm)
    return local_grid_from_cloud(pts_b, ok, nrm_b, cell_size=cell_size, **kw)


# ------------------------------------------------------------- global assembly


class OccupancyGrid:
    """Global 2-D log-odds grid on ``device`` (None = the CUDA card),
    assembled from per-node local grids at their (optimized) poses;
    re-assembles from its cache when the poses change (reference:
    global_map/OccupancyGrid + GlobalMap::update/assemble)."""

    OCC_INC = 0.85
    FREE_DEC = 0.7  # sigmoid(-0.7) = 0.33 < the free threshold after one hit
    CLAMP = 4.0

    def __init__(self, cell_size: float = 0.05, size_m: float = 40.0, up_axis: int = 2,
                 device: DeviceLike = None):
        """``up_axis``: which world axis is vertical (default z). The grid
        lies in the plane of the other two; a pose passed to
        update/assemble is the node's base pose (x forward, z up locally)."""
        self.device = resolve_device(device)
        self.cell = cell_size
        self.n = int(size_m / cell_size)
        self.origin = -size_m / 2.0
        self.plane = tuple(a for a in (0, 1, 2) if a != up_axis)
        self.logodds = torch.zeros((self.n, self.n), dtype=torch.float32, device=self.device)
        self.cache: Dict[int, LocalGrid] = {}
        self.poses: Dict[int, np.ndarray] = {}

    def _to_cells(self, pose, xy: torch.Tensor, valid: torch.Tensor):
        dev = self.device
        P = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        pts3 = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=-1)
        world = T.apply(P[None], pts3[None])[0][:, list(self.plane)]
        cell = torch.tensor(self.cell, dtype=torch.float32, device=dev)
        cx = torch.floor((world[:, 0] - self.origin) / cell).to(torch.int64)
        cy = torch.floor((world[:, 1] - self.origin) / cell).to(torch.int64)
        ok = valid & (cx >= 0) & (cx < self.n) & (cy >= 0) & (cy < self.n)
        return cx, cy, ok

    def _apply_node(self, logodds: torch.Tensor, pose, grid: LocalGrid, sign: float = 1.0):
        n2 = self.n * self.n
        for xy, v, delta in ((grid.obstacles, grid.obstacles_valid, self.OCC_INC),
                             (grid.ground, grid.ground_valid, -self.FREE_DEC),
                             (grid.empty, grid.empty_valid, -self.FREE_DEC)):
            cx, cy, ok = self._to_cells(pose, xy, v)
            idx = torch.where(ok, cy * self.n + cx, n2)
            vals = torch.where(ok, torch.tensor(sign * delta, device=self.device),
                               torch.zeros((), device=self.device))
            upd = torch.zeros((n2 + 1,), dtype=torch.float32,
                              device=self.device).index_add_(0, idx, vals)
            logodds = logodds + upd[:-1].reshape(self.n, self.n)
        return torch.clamp(logodds, -self.CLAMP, self.CLAMP)

    def update(self, node_id: int, pose, grid: LocalGrid):
        """Add or move one node's cells."""
        grid = grid.to(self.device)
        if node_id in self.cache:
            # take the old contribution out first (the pose changed)
            self.logodds = self._apply_node(self.logodds, self.poses[node_id],
                                            self.cache[node_id], sign=-1.0)
        self.cache[node_id] = grid
        self.poses[node_id] = np.asarray(pose)
        self.logodds = self._apply_node(self.logodds, pose, grid)

    def assemble(self, poses: Dict[int, np.ndarray]):
        """Full re-assembly at new poses (the graph was re-optimized)."""
        self.logodds = torch.zeros_like(self.logodds)
        for nid, pose in poses.items():
            if nid in self.cache:
                self.poses[nid] = np.asarray(pose)
                self.logodds = self._apply_node(self.logodds, pose, self.cache[nid])

    def probability(self) -> torch.Tensor:
        return torch.sigmoid(self.logodds)

    def to_occupancy(self, occ_thr: float = 0.65, free_thr: float = 0.35) -> np.ndarray:
        """int8 map: -1 unknown, 0 free, 100 occupied (the ROS convention)."""
        p = self.probability().cpu().numpy()
        known = np.abs(self.logodds.cpu().numpy()) > 1e-3
        out = np.full(p.shape, -1, np.int8)
        out[known & (p >= occ_thr)] = 100
        out[known & (p <= free_thr)] = 0
        return out


class CloudMap:
    """Assembled world point cloud from per-node clouds (reference:
    global_map/CloudMap); host numpy, as in the twin."""

    def __init__(self, voxel: float = 0.05):
        self.voxel = voxel
        self.cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.poses: Dict[int, np.ndarray] = {}

    def update(self, node_id: int, pose, pts, valid):
        self.cache[node_id] = (to_numpy(pts), to_numpy(valid))
        self.poses[node_id] = np.asarray(pose)

    def assemble(self, poses: Optional[Dict[int, np.ndarray]] = None) -> np.ndarray:
        poses = poses or self.poses
        out = []
        for nid, (pts, valid) in self.cache.items():
            if nid not in poses:
                continue
            P = np.asarray(poses[nid], np.float32)
            world = np.einsum("ij,nj->ni", P[:, :3], pts) + P[:, 3]
            out.append(world[valid])
        if not out:
            return np.zeros((0, 3), np.float32)
        cloud = np.concatenate(out)
        if self.voxel > 0:
            q = np.floor(cloud / self.voxel).astype(np.int64)
            _, keep = np.unique(q, axis=0, return_index=True)
            cloud = cloud[np.sort(keep)]
        return cloud


def cleanup_local_grids(poses: Dict[int, np.ndarray], grids: Dict[int, LocalGrid],
                        cell_size: float = 0.05, size_m: float = 40.0, radius: int = 1,
                        filter_ground: bool = False, device: DeviceLike = None):
    """Drop each node's obstacle cells whose map cells, with their
    ``radius`` neighbourhood, are free in the assembled map: dynamic
    objects (reference: Rtabmap::cleanupLocalGrids). Returns (the cleaned
    grids, as numpy arrays, and the number of cells removed)."""
    occ = OccupancyGrid(cell_size=cell_size, size_m=size_m, device=device)
    for nid, g in grids.items():
        if nid in poses:
            occ.update(nid, poses[nid], g)
    # free by consensus, looser than the export threshold: a transient
    # object leaves one obstacle vote against many empty ones
    free = occ.to_occupancy(free_thr=0.45) == 0
    # erode the free mask by ``radius``
    for _ in range(radius):
        er = free.copy()
        er[1:] &= free[:-1]
        er[:-1] &= free[1:]
        er[:, 1:] &= free[:, :-1]
        er[:, :-1] &= free[:, 1:]
        free = er
    return _cleanup_against(free, occ, poses, grids, filter_ground)


def _cleanup_against(free: np.ndarray, occ: OccupancyGrid, poses, grids,
                     filter_ground: bool):
    removed = 0
    out: Dict[int, LocalGrid] = {}
    for nid, g in grids.items():
        if nid not in poses:
            out[nid] = g
            continue
        pose = poses[nid]

        def keep_mask(xy, valid):
            cx, cy, ok = (to_numpy(a) for a in occ._to_cells(
                pose, torch.as_tensor(to_numpy(xy), device=occ.device),
                torch.as_tensor(to_numpy(valid), device=occ.device)))
            in_free = np.zeros(len(cx), bool)
            in_free[ok] = free[cy[ok], cx[ok]]
            return to_numpy(valid) & ~in_free

        ob_keep = keep_mask(g.obstacles, g.obstacles_valid)
        removed += int(to_numpy(g.obstacles_valid).sum() - ob_keep.sum())
        gr_valid = to_numpy(g.ground_valid)
        if filter_ground:
            gr_keep = keep_mask(g.ground, g.ground_valid)
            removed += int(gr_valid.sum() - gr_keep.sum())
            gr_valid = gr_keep
        out[nid] = LocalGrid(to_numpy(g.ground), gr_valid, to_numpy(g.obstacles), ob_keep,
                             to_numpy(g.empty), to_numpy(g.empty_valid))
    return out, removed

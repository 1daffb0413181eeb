"""Scan-to-map (F2M) LiDAR/ICP odometry.

Port of ``rtabmap_tpu/odometry/scan_f2m.py``: the ICP odometry of the
reference's ``OdometryF2M`` when ``Reg/Strategy`` selects ICP (a local map
of up to ``OdomF2M/ScanMaxSize`` points; keyframe scans merged after
subtracting points within ``OdomF2M/ScanSubtractRadius`` of the map; a new
keyframe when the ICP correspondence ratio falls below
``Odom/ScanKeyFrameThr``), the odometry of the LidarMapping example.

One tick: point-to-plane ICP of the incoming scan against the map slab
from a constant-velocity guess, pose and velocity update, keyframe
decision, and on a keyframe the radius-subtract merge with oldest-first
cull. The JAX twin selects the merged state with a tree-wide
``where(add_kf, ...)``; here the keyframe flag is read on the host after
ICP and the merge (normals, K2 search, sort) runs only on a keyframe,
which gives the same state.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import cloud as CL
from rtabmap_tpu_torch.ops import icp as ICP
from rtabmap_tpu_torch.utils.params import Parameters


def np_ceil_log2(n: int) -> int:
    return int(max(0, (int(n) - 1)).bit_length())


class ScanF2MState(NamedTuple):
    map_pts: torch.Tensor      # (M,3) world-frame map points
    map_nrm: torch.Tensor      # (M,3) world-frame normals
    map_valid: torch.Tensor    # (M,) bool
    map_seen: torch.Tensor     # (M,) last-seen keyframe index (cull priority)
    pose: torch.Tensor         # (3,4) current sensor pose (world)
    vel: torch.Tensor          # (6,) twist per frame (constant-velocity model)
    kf_count: torch.Tensor     # () float32
    initialized: torch.Tensor  # () bool


class ScanOdomResult(NamedTuple):
    pose: torch.Tensor
    success: torch.Tensor
    corr_ratio: torch.Tensor    # () ICP correspondence ratio
    fitness_rmse: torch.Tensor
    covariance: torch.Tensor    # (6,6)
    keyframe_added: torch.Tensor
    nn_searches: int            # K2 searches this tick asked for


def init_state(map_capacity: int = 4096, device: DeviceLike = None) -> ScanF2MState:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return ScanF2MState(
        map_pts=torch.zeros((map_capacity, 3), **f32),
        map_nrm=torch.zeros((map_capacity, 3), **f32),
        map_valid=torch.zeros((map_capacity,), dtype=torch.bool, device=dev),
        map_seen=torch.full((map_capacity,), -1.0, **f32),
        pose=T.identity(**f32).clone(),
        vel=torch.zeros((6,), **f32),
        kf_count=torch.zeros((), **f32),
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
    )


def state_from_numpy(arrays, device: DeviceLike = None) -> ScanF2MState:
    """A ScanF2MState from the JAX package's state carried across as numpy
    (a mapping of its field names, or a NamedTuple such as the JAX state
    itself after ``np.asarray`` of each field), so that the port can
    continue a sequence the JAX package started."""
    dev = resolve_device(device)
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    out = {}
    for name in ScanF2MState._fields:
        a = np.asarray(arrays[name])
        dtype = torch.bool if a.dtype == np.bool_ else torch.float32
        out[name] = torch.as_tensor(a, dtype=dtype, device=dev).clone()
    return ScanF2MState(**out)


def _merge_scan(state: ScanF2MState, pts_w: torch.Tensor, nrm_w: torch.Tensor,
                valid: torch.Tensor, subtract_radius: float) -> ScanF2MState:
    """Keyframe merge: drop new points within ``subtract_radius`` of a map
    point, then keep the newest ``M`` points by seen-stamp. One K2 search.

    The JAX twin ranks with ``lax.top_k``, which keeps the lower index on
    ties; the priorities ``seen - i*1e-6`` tie in float32 once the keyframe
    count passes about 64, and every -inf ties, so the port ranks with a
    stable descending sort (``torch.topk`` promises no tie order)."""
    kf = state.kf_count + 1.0
    d2, _ = ICP._nn_blocked(pts_w, state.map_pts, state.map_valid)
    novel = valid & (d2 > subtract_radius ** 2)
    ninf = torch.tensor(float("-inf"), device=pts_w.device)
    all_pts = torch.cat([state.map_pts, pts_w], dim=0)
    all_nrm = torch.cat([state.map_nrm, nrm_w], dim=0)
    all_valid = torch.cat([state.map_valid, novel], dim=0)
    all_seen = torch.cat([torch.where(state.map_valid, state.map_seen, ninf),
                          torch.where(novel, kf, ninf)], dim=0)
    M = state.map_pts.shape[0]
    prio = all_seen - torch.arange(all_seen.shape[0], dtype=torch.float32,
                                   device=pts_w.device) * 1e-6
    keep = torch.sort(prio, descending=True, stable=True).indices[:M]
    kept_valid = all_valid[keep]
    return state._replace(
        map_pts=all_pts[keep], map_nrm=all_nrm[keep], map_valid=kept_valid,
        map_seen=torch.where(kept_valid, all_seen[keep], torch.full_like(prio[:M], -1.0)),
        kf_count=kf)


def _diag_cov(var: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.cat([var.expand(3), (var * 0.1).expand(3)]))


def scan_odom_step(state: ScanF2MState, scan_pts: torch.Tensor, scan_valid: torch.Tensor,
                   *, voxel: float = 0.05, icp_iters: int = 20,
                   max_corr_dist: float = 0.5, min_corr_ratio: float = 0.2,
                   keyframe_thr: float = 0.9, subtract_radius: float = 0.05,
                   vel_smooth: float = 0.7,
                   normals_k: int = 8) -> Tuple[ScanF2MState, ScanOdomResult]:
    """One scan-odometry tick. ``scan_pts`` (N,3) in the sensor frame,
    ``scan_valid`` (N,) mask, on the state's device. Reads two flags on the
    host: ``initialized`` before, and the keyframe decision after ICP."""
    dev = scan_pts.device
    scan_valid = CL.voxel_filter(scan_pts, scan_valid, voxel)

    def merged_at(st: ScanF2MState, pose: torch.Tensor, radius: float) -> ScanF2MState:
        pts_w = T.apply(pose[None], scan_pts[None])[0]
        nrm_s, _ = CL.estimate_normals(scan_pts, scan_valid, k=normals_k)
        return _merge_scan(st, pts_w, nrm_s @ T.rotation(pose).T, scan_valid, radius)

    if not bool(state.initialized):
        st = merged_at(state, state.pose, 0.0)._replace(
            initialized=torch.ones((), dtype=torch.bool, device=dev))
        res = ScanOdomResult(
            pose=state.pose, success=torch.ones((), dtype=torch.bool, device=dev),
            corr_ratio=torch.ones((), device=dev), fitness_rmse=torch.zeros((), device=dev),
            covariance=torch.eye(6, device=dev) * 1e-6,
            keyframe_added=torch.ones((), dtype=torch.bool, device=dev), nn_searches=1)
        return st, res

    guess = T.compose(state.pose, T.se3_exp(state.vel))
    # ICP solves for the sensor->world transform directly (the map is in
    # the world frame), seeded with the constant-velocity guess
    icp_res = ICP.icp(scan_pts, scan_valid, state.map_pts, state.map_valid,
                      guess=guess, dst_normals=state.map_nrm, iters=icp_iters,
                      max_corr_dist=max_corr_dist, point_to_plane=True,
                      min_corr_ratio=min_corr_ratio)
    new_pose = T.orthonormalize(icp_res.transform)
    ok = icp_res.valid
    new_vel = T.se3_log(T.relative(state.pose, new_pose))
    vel = torch.where(ok, vel_smooth * new_vel + (1 - vel_smooth) * state.vel,
                      torch.zeros_like(state.vel))
    pose = torch.where(ok, new_pose, state.pose)
    # keyframe: the correspondence ratio fell below Odom/ScanKeyFrameThr
    add_kf = ok & (icp_res.correspondence_ratio < keyframe_thr)
    searches = icp_iters + 1
    if bool(add_kf):
        state = merged_at(state, pose, subtract_radius)
        searches += 1
    state = state._replace(pose=pose, vel=vel)

    var = torch.clamp_min(icp_res.fitness_rmse ** 2, 1e-8)
    cov = torch.where(ok, 1.0, 9999.0) * _diag_cov(var)
    res = ScanOdomResult(pose=pose, success=ok, corr_ratio=icp_res.correspondence_ratio,
                         fitness_rmse=icp_res.fitness_rmse, covariance=cov,
                         keyframe_added=add_kf, nn_searches=searches)
    return state, res


class OdometryScanF2M:
    """Host wrapper with the reference Odometry::process semantics
    (constant-velocity guess, lost -> covariance 9999, reset)."""

    def __init__(self, cam=None, params: Optional[Parameters] = None, seed: int = 0,
                 map_capacity: Optional[int] = None, scan_voxel: float = 0.05,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        p = params or Parameters()
        if map_capacity is None:
            # the reference's OdomF2M/ScanMaxSize rounded up to a power of two
            map_capacity = max(1024, int(2 ** np_ceil_log2(int(p["OdomF2M/ScanMaxSize"]))))
        self.cam = cam  # unused; kept for the factory's signature
        self._kw = dict(
            voxel=scan_voxel,
            icp_iters=int(p["Icp/Iterations"]),
            max_corr_dist=float(p["Icp/MaxCorrespondenceDistance"]),
            min_corr_ratio=float(p["Icp/CorrespondenceRatio"]),
            keyframe_thr=float(p["Odom/ScanKeyFrameThr"]),
            subtract_radius=float(p["OdomF2M/ScanSubtractRadius"]),
        )
        self.state = init_state(map_capacity, self.device)
        self.lost = False

    def process(self, scan_pts, scan_valid=None, imu_quat=None):
        """-> (pose (3,4) or None when lost, covariance (6,6), info)."""
        pts = torch.as_tensor(scan_pts, dtype=torch.float32, device=self.device)
        if scan_valid is None:
            valid = torch.ones((pts.shape[0],), dtype=torch.bool, device=self.device)
        else:
            valid = torch.as_tensor(scan_valid, dtype=torch.bool, device=self.device)
        self.state, res = scan_odom_step(self.state, pts, valid, **self._kw)
        ok, ratio, rmse, kf, n_map = torch.stack([
            res.success.float(), res.corr_ratio, res.fitness_rmse,
            res.keyframe_added.float(), self.state.map_valid.sum().float()]).tolist()
        self.lost = not ok
        info = {"corr_ratio": ratio, "fitness_rmse": rmse, "keyframe": bool(kf),
                "map_points": int(n_map), "nn_searches": res.nn_searches}
        if not ok:
            return None, torch.eye(6, device=self.device) * 9999.0, info
        return res.pose, res.covariance, info

    def reset(self, pose=None):
        self.state = init_state(self.state.map_pts.shape[0], self.device)
        if pose is not None:
            self.state = self.state._replace(
                pose=torch.as_tensor(pose, dtype=torch.float32, device=self.device))

    @property
    def pose(self) -> torch.Tensor:
        return self.state.pose

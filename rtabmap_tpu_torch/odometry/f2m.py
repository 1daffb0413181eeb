"""Frame-to-Map (F2M) visual odometry, the default odometry strategy.

Port of ``rtabmap_tpu/odometry/f2m.py`` (the reference's ``OdometryF2M``:
registration of each frame against a local map of up to
``OdomF2M/MaxSize`` points, keyframes on the inlier ratio
``Odom/KeyFrameThr``, map insert and oldest-first cull, local bundle
adjustment over the last keyframes, the constant-velocity guess, and the
gravity alignment of a tracked pose to an IMU orientation).

The map, its descriptors and the keyframe window live on the device in
fixed-capacity tensors. Where the JAX twin selects the keyframe branch
with masked selects inside one jitted step, the port decides on the host:
``odom_step`` fetches the frame's success, keyframe decision and counts
in ONE transfer (the fetch the JAX wrapper makes for ``bool(success)``)
and inserts the keyframe only when needed. Counters the host decides
anyway (``initialized``, ``age``, ``kf_count``, ``kf_ptr``) are host
values, so no other step waits for the device.

Ranking for the map cull is an explicit stable sort on the last-seen
keyframe (lower slot first among equals), which is the order the JAX
twin's ``lax.top_k`` on ``seen - index * 1e-6`` gives; ``torch.topk``
promises no order among ties.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import ransac as R
from rtabmap_tpu_torch.ops.features import DESC_DIM
from rtabmap_tpu_torch.optim.ba import BAProblem, bundle_adjust, outlier_mask


class F2MState(NamedTuple):
    map_pts: torch.Tensor    # (M,3) world-frame map points
    map_desc: torch.Tensor   # (M,D) +-1 int8
    map_valid: torch.Tensor  # (M,)
    map_seen: torch.Tensor   # (M,) float32 last-seen keyframe index (cull priority)
    pose: torch.Tensor       # (3,4) current camera pose (world)
    vel: torch.Tensor        # (6,) twist per frame (constant-velocity model)
    kf_count: float          # keyframe counter (host)
    initialized: bool        # (host)
    age: float               # ticks since bootstrap/reset (host)
    map_ids: torch.Tensor    # (M,) int32 persistent point ids (-1 empty)
    next_id: torch.Tensor    # () int32 id counter
    obs_ids: torch.Tensor    # (F,K) int32 point id per observation (-1 none)
    obs_uv: torch.Tensor     # (F,K,2) pixel observation
    kf_poses: torch.Tensor   # (F,3,4) keyframe camera-in-world poses
    kf_valid: torch.Tensor   # (F,) ring slot occupied
    kf_stamp: torch.Tensor   # (F,) float32 kf_count at insertion (age order)
    kf_ptr: int              # ring pointer (host)


class OdomResult(NamedTuple):
    pose: torch.Tensor        # (3,4) new pose (valid only if success)
    success: bool
    num_matches: int
    num_inliers: int
    covariance: torch.Tensor  # (6,6)
    keyframe_added: bool


def init_state(map_capacity: int = 2000, desc_dim: int = DESC_DIM, ba_frames: int = 10,
               obs_capacity: int = 512, device: DeviceLike = None) -> F2MState:
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return F2MState(
        map_pts=torch.zeros((map_capacity, 3), **f32),
        map_desc=torch.zeros((map_capacity, desc_dim), dtype=torch.int8, device=dev),
        map_valid=torch.zeros((map_capacity,), dtype=torch.bool, device=dev),
        map_seen=torch.full((map_capacity,), -1.0, **f32),
        pose=T.identity(device=dev).clone(),
        vel=torch.zeros((6,), **f32),
        kf_count=0.0, initialized=False, age=0.0,
        map_ids=torch.full((map_capacity,), -1, dtype=torch.int32, device=dev),
        next_id=torch.zeros((), dtype=torch.int32, device=dev),
        obs_ids=torch.full((ba_frames, obs_capacity), -1, dtype=torch.int32, device=dev),
        obs_uv=torch.zeros((ba_frames, obs_capacity, 2), **f32),
        kf_poses=T.identity((ba_frames,), device=dev).clone(),
        kf_valid=torch.zeros((ba_frames,), dtype=torch.bool, device=dev),
        kf_stamp=torch.full((ba_frames,), -1.0, **f32),
        kf_ptr=0,
    )


def _insert_keyframe(state: F2MState, frame: FrameFeatures, new_pose: torch.Tensor,
                     matched_map_idx: torch.Tensor, matched_ok: torch.Tensor) -> F2MState:
    """Refresh the seen-stamps of matched points, merge the frame's
    unmatched 3D points, keep the most recently seen (oldest-first cull),
    and record the keyframe's observations in the BA ring."""
    kf = state.kf_count + 1.0
    idx = matched_map_idx.long()
    seen = state.map_seen.scatter_reduce(
        0, idx, torch.where(matched_ok, kf, -1.0), reduce="amax", include_self=True)
    new_mask = frame.valid & frame.valid3d & ~matched_ok
    world_pts = T.apply(new_pose, frame.pts3d)
    ninf = torch.tensor(float("-inf"), device=seen.device)
    cand_seen = torch.where(new_mask, kf, ninf)
    new_ids = state.next_id + torch.cumsum(new_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    new_ids = torch.where(new_mask, new_ids, -1)

    all_pts = torch.cat([state.map_pts, world_pts])
    all_desc = torch.cat([state.map_desc, frame.desc])
    all_valid = torch.cat([state.map_valid, new_mask])
    all_seen = torch.cat([torch.where(state.map_valid, seen, ninf), cand_seen])
    all_ids = torch.cat([state.map_ids, new_ids])
    Mcap = state.map_pts.shape[0]
    # (seen desc, slot asc): a stable descending sort keeps equal seen in
    # slot order, as lax.top_k does on the JAX twin's seen - slot * 1e-6
    keep = torch.sort(all_seen, descending=True, stable=True).indices[:Mcap]

    obs_id_k = torch.where(matched_ok, state.map_ids[idx],
                           torch.where(new_mask, new_ids, -1)).to(torch.int32)
    Fw, Kw = state.obs_ids.shape
    K = obs_id_k.shape[0]
    if K >= Kw:
        obs_id_k, obs_uv_k = obs_id_k[:Kw], frame.uv[:Kw]
    else:
        obs_id_k = torch.nn.functional.pad(obs_id_k, (0, Kw - K), value=-1)
        obs_uv_k = torch.nn.functional.pad(frame.uv, (0, 0, 0, Kw - K))
    slot = state.kf_ptr % Fw
    obs_ids, obs_uv = state.obs_ids.clone(), state.obs_uv.clone()
    kf_poses, kf_valid = state.kf_poses.clone(), state.kf_valid.clone()
    kf_stamp = state.kf_stamp.clone()
    obs_ids[slot] = obs_id_k
    obs_uv[slot] = obs_uv_k
    kf_poses[slot] = new_pose
    kf_valid[slot] = True
    kf_stamp[slot] = kf
    kept_valid = all_valid[keep]
    return state._replace(
        map_pts=all_pts[keep], map_desc=all_desc[keep], map_valid=kept_valid,
        map_seen=torch.where(kept_valid, all_seen[keep], -1.0),
        map_ids=torch.where(kept_valid, all_ids[keep], -1),
        next_id=state.next_id + new_mask.sum().to(torch.int32),
        kf_count=kf, obs_ids=obs_ids, obs_uv=obs_uv, kf_poses=kf_poses,
        kf_valid=kf_valid, kf_stamp=kf_stamp, kf_ptr=state.kf_ptr + 1)


def odom_step(state: F2MState, frame: FrameFeatures, cam: C.CameraModel,
              generator: Optional[torch.Generator] = None, nndr: float = 0.8,
              reproj_px: float = 4.0, min_inliers: int = 20, keyframe_thr: float = 0.3,
              ransac_iters: int = 192, search_window: float = 0.0, vel_smooth: float = 0.7,
              indices: Optional[Tuple[torch.Tensor, ...]] = None
              ) -> Tuple[F2MState, OdomResult]:
    """One odometry tick: bootstrap an empty map with the frame, or match
    the frame against the map, PnP-RANSAC from the constant-velocity guess,
    update pose and velocity, and insert a keyframe when the inlier count
    falls below ``keyframe_thr`` of the frame's features. ``indices``
    replaces RANSAC's drawn samples (see ``ransac.pnp_sample_indices``)."""
    dev = state.pose.device
    if not state.initialized:
        no_match = torch.zeros((frame.capacity,), dtype=torch.bool, device=dev)
        st = _insert_keyframe(state, frame, state.pose, torch.zeros_like(no_match, dtype=torch.int32),
                              no_match)
        res = OdomResult(pose=state.pose, success=True, num_matches=0, num_inliers=0,
                         covariance=torch.eye(6, device=dev) * 1e-6, keyframe_added=True)
        return st._replace(initialized=True, age=state.age + 1.0), res

    guess = T.compose(state.pose, T.se3_exp(state.vel))
    map_valid = state.map_valid
    if search_window > 0.0:
        # the guess-projected window: map points projected through the
        # guess, those in front and inside the image (grown by the window)
        # are candidates, and a match must land within the window
        uv_pred, z_pred = C.project(T.apply(T.inverse(guess), state.map_pts), cam)
        map_valid = map_valid & (z_pred > 0.05) & C.in_image(
            uv_pred, cam.width, cam.height, -search_window)
    m = M.match_nndr(frame.desc, frame.valid, state.map_desc, map_valid, nndr=nndr)
    if search_window > 0.0:
        du = uv_pred[m.idx.long()] - frame.uv
        m = m._replace(valid=m.valid & ((du * du).sum(-1) <= search_window ** 2))
    n_matches = m.valid.sum()
    res = R.ransac_pnp(
        state.map_pts[m.idx.long()], frame.uv, m.valid, cam, generator,
        iters=ransac_iters, reproj_px=reproj_px, min_inliers=min_inliers, guess=guess,
        pts3d_query=torch.where(frame.valid3d[:, None], frame.pts3d, 0.0), indices=indices)
    ok = res.success
    new_pose = torch.where(ok, res.transform, state.pose)
    motion = T.se3_log(T.relative(state.pose, new_pose))
    new_vel = torch.where(ok, vel_smooth * motion + (1 - vel_smooth) * state.vel,
                          torch.zeros_like(state.vel))
    n_feat = frame.valid.sum()
    kf_needed = ok & (res.num_inliers < keyframe_thr * torch.clamp_min(n_feat, 1))
    # the one fetch of the tick: success, keyframe decision, counts
    ok_h, kf_h, n_match_h, n_inl_h = torch.stack(
        [ok.to(torch.int32), kf_needed.to(torch.int32), n_matches.to(torch.int32),
         res.num_inliers]).tolist()
    st = state
    if kf_h:
        st = _insert_keyframe(state, frame, new_pose, m.idx, m.valid & res.inliers)
    st = st._replace(pose=new_pose, vel=new_vel, age=state.age + 1.0)
    # Covariance maturity: the first estimates after a reset track one
    # depth-projected keyframe; their claimed certainty decays from 1e5x
    # to 1x over the first 5 tracked ticks (age counts the bootstrap).
    cov_boost = 10.0 ** (5.0 * float(np.clip(1.0 - (state.age - 1.0) / 5.0, 0.0, 1.0)))
    out = OdomResult(pose=new_pose, success=bool(ok_h), num_matches=int(n_match_h),
                     num_inliers=int(n_inl_h), covariance=res.covariance * cov_boost,
                     keyframe_added=bool(kf_h))
    return st, out


def local_ba_step(state: F2MState, cam: C.CameraModel, iters: int = 4,
                  huber_px: float = 3.0, prune_px: float = 8.0) -> F2MState:
    """Local bundle adjustment over the keyframe window: observation ids
    resolve to current map slots by one (F*K, M) equality; the oldest
    window frame anchors the gauge; refined points and poses are written
    back, and gross outlier observations are pruned from the window."""
    if min(state.kf_ptr, state.kf_valid.shape[0]) < 2:
        return state                       # fewer than two keyframes
    Fw, Kw = state.obs_ids.shape
    dev = state.map_pts.device
    obs_ids = state.obs_ids.reshape(-1)
    obs_uv = state.obs_uv.reshape(-1, 2)
    frame_of = torch.arange(Fw, dtype=torch.int64, device=dev).repeat_interleave(Kw)
    eq = (obs_ids[:, None] == state.map_ids[None, :]) & state.map_valid[None, :]
    slot = torch.argmax(eq.to(torch.uint8), dim=1)
    ok = eq.any(dim=1) & (obs_ids >= 0) & state.kf_valid[frame_of]
    uv_norm = torch.stack([(obs_uv[:, 0] - cam.cx) / cam.fx,
                           (obs_uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    inf = torch.tensor(float("inf"), device=dev)
    oldest = torch.argmin(torch.where(state.kf_valid, state.kf_stamp, inf))
    fixed = (torch.arange(Fw, device=dev) == oldest) | ~state.kf_valid
    prob = BAProblem(poses=T.inverse(state.kf_poses), points=state.map_pts,
                     cam_idx=frame_of, pt_idx=slot, uv=uv_norm, valid=ok, fixed_cams=fixed)
    out, _ = bundle_adjust(prob, iters=iters, huber=huber_px / float(cam.fx))
    bad = outlier_mask(out, prune_px / float(cam.fx)) & ok
    new_obs_ids = torch.where(bad, -1, obs_ids).reshape(Fw, Kw)
    # "any ok observation" of each slot (duplicate slots: a reduction, not
    # an indexed write)
    touched = torch.zeros(state.map_pts.shape[0], device=dev).index_add_(
        0, slot, ok.to(torch.float32)) > 0
    new_pts = torch.where((touched & state.map_valid)[:, None], out.points, state.map_pts)
    new_kf_poses = torch.where(state.kf_valid[:, None, None], T.inverse(out.poses),
                               state.kf_poses)
    newest = torch.argmax(torch.where(state.kf_valid, state.kf_stamp, -inf))
    return state._replace(map_pts=new_pts, kf_poses=new_kf_poses, pose=new_kf_poses[newest],
                          obs_ids=new_obs_ids)


class OdometryF2M:
    """Host wrapper with the reference's ``process()`` semantics: on
    tracking loss it returns a None transform and covariance 9999
    (Odometry.cpp's failure convention); ``reset()`` restarts the map.
    Runs on ``device`` (None = the CUDA card)."""

    def __init__(self, cam: C.CameraModel, params=None, map_capacity: int = 2000,
                 max_features: int = 512, seed: int = 0, device: DeviceLike = None):
        from rtabmap_tpu_torch.utils.params import Parameters

        p = params or Parameters()
        self.device = resolve_device(device)
        self.cam = cam
        self.max_features = int(p["Vis/MaxFeatures"] or max_features)
        self.ba_enabled = int(p["OdomF2M/BundleAdjustment"]) > 0
        ba_frames = int(p["OdomF2M/BundleAdjustmentMaxFrames"]) or 10
        self._ba_frames = max(2, min(ba_frames, 10))
        self.state = init_state(int(p["OdomF2M/MaxSize"]) or map_capacity,
                                ba_frames=self._ba_frames, obs_capacity=self.max_features,
                                device=self.device)
        self.keyframe_thr = float(p["Odom/KeyFrameThr"])
        self.min_inliers = int(p["Vis/MinInliers"])
        self.nndr = float(p["Vis/CorNNDR"])
        self.reproj_px = float(p["Vis/PnPReprojError"])
        self.generator = torch.Generator().manual_seed(seed)   # RANSAC draws (CPU)
        self.lost = False

    def process(self, frame: FrameFeatures, imu_quat=None, indices=None):
        """Track ``frame``; with ``imu_quat`` (the IMU filter's orientation
        [x,y,z,w]) a tracked pose takes the IMU's roll and pitch.
        ``indices`` replaces RANSAC's drawn samples (see ``odom_step``)."""
        self.state, res = odom_step(
            self.state, frame, self.cam, self.generator, nndr=self.nndr,
            reproj_px=self.reproj_px, min_inliers=self.min_inliers,
            keyframe_thr=self.keyframe_thr, indices=indices)
        if res.success and self.ba_enabled and res.keyframe_added:
            # the refined newest-keyframe pose becomes the output pose
            self.state = local_ba_step(self.state, self.cam)
            res = res._replace(pose=self.state.pose)
        if res.success and imu_quat is not None:
            from rtabmap_tpu_torch.odometry.imu_filter import apply_gravity_alignment

            q = torch.as_tensor(imu_quat, dtype=torch.float32, device=self.device)
            aligned = apply_gravity_alignment(res.pose, q)
            self.state = self.state._replace(pose=aligned)
            res = res._replace(pose=aligned)
        self.lost = not res.success
        info = {"matches": res.num_matches, "inliers": res.num_inliers,
                "keyframe": res.keyframe_added}
        if not res.success:
            return None, torch.eye(6) * 9999.0, info
        return res.pose, res.covariance, info

    def reset(self, pose=None):
        cap = self.state.map_pts.shape[0]
        self.state = init_state(cap, ba_frames=self.state.obs_ids.shape[0],
                                obs_capacity=self.state.obs_ids.shape[1], device=self.device)
        if pose is not None:
            self.state = self.state._replace(
                pose=torch.as_tensor(np.asarray(pose, np.float32), device=self.device))

    @property
    def pose(self):
        return self.state.pose

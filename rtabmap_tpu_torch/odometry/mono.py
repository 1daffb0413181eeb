"""Monocular visual odometry: two-view bootstrap + landmark PnP.

Port of ``rtabmap_tpu/odometry/mono.py`` (the reference's
``OdometryMono``): track against the first keyframe until enough image
flow, initialise the up-to-scale map from the two-view pose (the better
supported of an essential matrix and a homography) and midpoint
triangulation, polished by a two-view bundle adjustment, then localise
each frame by PnP against the landmark slab, refine a sliding window by
local bundle adjustment, and grow the map by triangulating fresh
correspondences against the last keyframe. The scale is fixed by setting
the bootstrap baseline to ``OdomMono/InitialBaseline``.

The landmark slab (points, descriptors, flags) lives on the device; the
cursor that hands out its slots is a host value. The RANSAC's sample
indices come from a CPU ``torch.Generator`` or are passed to ``process``
(``indices=``): the bootstrap takes the pair (essential samples (iters,
8), homography samples (iters, 4)), the tracking the tuple of
``ransac.pnp_sample_indices`` without query 3D.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import epipolar as EP
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import ransac as RS
from rtabmap_tpu_torch.optim.ba import BAProblem, bundle_adjust


def _norm_coords(uv: torch.Tensor, cam: C.CameraModel) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1)


def _bootstrap(kf: FrameFeatures, fr: FrameFeatures, cam: C.CameraModel,
               generator: Optional[torch.Generator], nndr: float, threshold: float,
               iters: int = 192, indices=None):
    """Match kf -> fr (mutual NNDR), fit both an essential matrix and a
    homography (the dual-model bootstrap: planar or low-parallax scenes
    make E degenerate) and keep the one with more support (H when it holds
    over 45% of both inlier sets), polish the pose and the triangulated
    structure by a two-view BA, then fix the baseline to unit length.
    Returns (median flow px, T21, inlier count, pts (K,3) in kf's camera,
    pts_ok (K,), kf -> fr match indices), K = kf's capacity."""
    m = M.match_mutual_nndr(kf.desc, kf.valid, fr.desc, fr.valid, nndr=nndr)
    idx = m.idx.long()
    uv2 = fr.uv[idx]
    flow = torch.where(m.valid, torch.linalg.norm(uv2 - kf.uv, dim=-1), 0.0)
    med_flow = flow.sum() / torch.clamp_min(m.valid.sum(), 1)
    x1n = _norm_coords(kf.uv, cam)
    x2n = _norm_coords(uv2, cam)
    idx_e, idx_h = indices if indices is not None else (None, None)
    T21e, inle, Xe, oke = EP.ransac_essential(x1n, x2n, m.valid, generator, iters=iters,
                                              threshold=threshold, indices=idx_e)
    Hm, inlh = EP.ransac_homography(x1n, x2n, m.valid, generator, iters=iters,
                                    threshold=threshold, indices=idx_h)
    T21h, Xh, okh = EP.pose_from_homography(Hm, x1n, x2n, inlh)
    use_h = inlh.sum() > 0.45 * (inlh.sum() + inle.sum())
    T21 = torch.where(use_h, T21h, T21e)
    X = torch.where(use_h, Xh, Xe)
    ok = torch.where(use_h, okh, oke)
    inl = torch.where(use_h, inlh, inle)
    K = x1n.shape[0]
    dev = x1n.device
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    prob = BAProblem(
        poses=torch.stack([T.identity(device=dev), T21]), points=X,
        cam_idx=torch.cat([torch.zeros(K, dtype=torch.int32, device=dev),
                           torch.ones(K, dtype=torch.int32, device=dev)]),
        pt_idx=torch.cat([ar, ar]), uv=torch.cat([x1n, x2n]), valid=torch.cat([ok, ok]),
        fixed_cams=torch.tensor([True, False], device=dev))
    refined, _ = bundle_adjust(prob, iters=12, damping=1e-3, huber=4.0 * threshold)
    T21r = refined.poses[1]
    s = 1.0 / torch.clamp_min(torch.linalg.norm(T.translation(T21r)), 1e-9)
    T21 = torch.cat([T.rotation(T21r), T.translation(T21r)[:, None] * s], dim=1)
    X = refined.points * s
    z1 = X[:, 2]
    z2 = (torch.einsum("ij,nj->ni", T.rotation(T21), X) + T.translation(T21)[None])[:, 2]
    ok = ok & (z1 > 1e-3) & (z2 > 1e-3)
    return med_flow, T21, inl.sum(), X, ok, m.idx


def _track(map_xyz, map_desc, map_valid, fr: FrameFeatures, cam: C.CameraModel,
           generator: Optional[torch.Generator], guess, nndr: float, reproj_px: float,
           iters: int = 192, min_inliers: int = 15, indices=None):
    """Frame -> landmark-map PnP from ``guess`` (camera-in-world).
    Returns (RansacResult, Matches)."""
    m = M.match_nndr(fr.desc, fr.valid, map_desc, map_valid, nndr=nndr)
    res = RS.ransac_pnp(map_xyz[m.idx.long()], fr.uv, m.valid, cam, generator, iters=iters,
                        reproj_px=reproj_px, min_inliers=min_inliers, guess=guess,
                        indices=indices)
    return res, m


def _triangulate_new(kf: FrameFeatures, kf_pose, fr: FrameFeatures, fr_pose,
                     cam: C.CameraModel, nndr: float, min_parallax: float):
    """Fresh landmarks between a keyframe and the current frame (both
    poses camera-in-world): mutual matches triangulated at their midpoint,
    kept in front of both cameras with rays at least ``min_parallax``
    (radians) apart. Returns (world points, mask, kf's descriptors)."""
    m = M.match_mutual_nndr(kf.desc, kf.valid, fr.desc, fr.valid, nndr=nndr)
    T21 = T.relative(fr_pose, kf_pose)      # X_fr = R X_kf + t
    x1n = _norm_coords(kf.uv, cam)
    x2n = _norm_coords(fr.uv[m.idx.long()], cam)
    R21 = T.rotation(T21)
    X1, z1, z2 = EP.triangulate_midpoint(R21, T.translation(T21), x1n, x2n)
    one = torch.ones((*x1n.shape[:-1], 1), dtype=x1n.dtype, device=x1n.device)
    d1 = torch.cat([x1n, one], -1)
    d2 = torch.einsum("ji,nj->ni", R21, torch.cat([x2n, one], -1))
    cosang = (d1 * d2).sum(-1) / torch.clamp_min(
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1), 1e-9)
    cos_min = torch.cos(torch.tensor(min_parallax, dtype=torch.float32))
    ok = m.valid & (z1 > 1e-2) & (z2 > 1e-2) & (cosang < cos_min.to(cosang.device))
    return T.apply(kf_pose, X1), ok, kf.desc


def _local_ba(map_xyz, poses, obs_idx, obs_uv_n, obs_ok, iters: int = 6):
    """Sliding-window local bundle adjustment over the landmark slab:
    poses (W,3,4) camera-in-world, obs_* (W,K) observations of slab
    landmarks (normalised coordinates). The two oldest cameras are fixed,
    pinning the gauge and the window's scale. Returns (refined poses,
    refined slab points, final cost)."""
    W, K = obs_idx.shape
    dev = map_xyz.device
    prob = BAProblem(
        poses=T.inverse(poses), points=map_xyz,
        cam_idx=torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(K),
        pt_idx=obs_idx.reshape(-1), uv=obs_uv_n.reshape(-1, 2), valid=obs_ok.reshape(-1),
        fixed_cams=torch.arange(W, device=dev) < 2)
    ref, cost = bundle_adjust(prob, iters=iters, damping=1e-3, huber=0.01)
    return T.inverse(ref.poses), ref.points, cost


def _map_insert(map_xyz, map_desc, map_valid, slots, pts, desc, mask) -> None:
    """Write the masked rows into their slab slots, in place."""
    sel = torch.nonzero(mask).reshape(-1)
    at = slots[sel].long()
    map_xyz[at] = pts[sel]
    map_desc[at] = desc[sel]
    map_valid[at] = True


class OdometryMono:
    """Host wrapper with the reference's ``process()`` semantics: returns
    (pose T_wc, covariance, info); the pose is None while bootstrapping or
    lost. Runs on ``device`` (None = the CUDA card)."""

    def __init__(self, cam: C.CameraModel, params=None, map_capacity: int = 4096,
                 seed: int = 0, ba_window: int = 4, device: DeviceLike = None):
        from rtabmap_tpu_torch.utils.params import Parameters

        p = params or Parameters()
        self.device = resolve_device(device)
        self.cam = cam
        self.ba_window = ba_window
        self.nndr = float(p["Vis/CorNNDR"])
        self.reproj_px = float(p["Vis/PnPReprojError"])
        self.min_inliers = int(p["Vis/MinInliers"])
        self.min_flow = float(p["OdomMono/InitMinFlow"])
        self.baseline = float(p["OdomMono/InitialBaseline"])
        self.min_parallax = float(p["OdomMono/MinParallax"]) * np.pi / 180.0
        self.capacity = map_capacity
        self.generator = torch.Generator().manual_seed(seed)   # RANSAC draws (CPU)
        self.reset()

    def reset(self, pose=None):
        dev = self.device
        self.pose = (T.identity(device=dev) if pose is None else
                     torch.as_tensor(np.asarray(pose, np.float32), device=dev))
        self.vel = torch.zeros((6,), device=dev)
        self.initialized = False
        self.lost = False
        self.keyframe: Optional[FrameFeatures] = None
        self.keyframe_pose = self.pose
        self.map_xyz = torch.zeros((self.capacity, 3), device=dev)
        self.map_desc = None
        self.map_valid = torch.zeros((self.capacity,), dtype=torch.bool, device=dev)
        self.n_landmarks = 0
        self._window = []  # [(pose, obs_idx, obs_uv_n, obs_ok)] for the local BA

    def _insert(self, pts, desc, mask):
        mask = mask.cpu().numpy()
        free = self.capacity - self.n_landmarks
        if int(mask.sum()) > free:
            mask = mask & (np.cumsum(mask) <= free)
        slots = (self.n_landmarks + np.cumsum(mask) - 1).astype(np.int64)
        _map_insert(self.map_xyz, self.map_desc, self.map_valid,
                    torch.from_numpy(slots).to(self.device), pts, desc,
                    torch.from_numpy(mask).to(self.device))
        self.n_landmarks += int(mask.sum())

    def process(self, frame: FrameFeatures, indices=None):
        """Bootstrap or track ``frame`` -> (pose, covariance, info).
        ``indices`` replaces the frame's RANSAC samples (see the module
        docstring)."""
        info = {"matches": 0, "inliers": 0, "initialized": self.initialized}
        if self.map_desc is None:
            self.map_desc = torch.zeros((self.capacity, frame.desc.shape[1]),
                                        dtype=torch.int8, device=self.device)
        if self.keyframe is None:
            self.keyframe = frame
            self.keyframe_pose = self.pose
            return None, None, info
        if not self.initialized:
            return self._initialize(frame, info, indices)
        return self._track_frame(frame, info, indices)

    def _initialize(self, frame: FrameFeatures, info: dict, indices):
        flow, T21, n_inl, X, ok, _ = _bootstrap(
            self.keyframe, frame, self.cam, self.generator, self.nndr,
            float(np.float32(self.reproj_px / self.cam.fx)), indices=indices)
        flow_h, n_inl_h, n_ok = torch.stack([flow, n_inl.float(), ok.sum().float()]).tolist()
        info["flow"] = flow_h
        info["inliers"] = int(n_inl_h)
        if flow_h < self.min_flow or int(n_ok) < self.min_inliers:
            return None, None, info  # keep waiting for baseline
        # scale: the unit bootstrap baseline -> InitialBaseline
        s = self.baseline
        T21 = torch.cat([T.rotation(T21), T.translation(T21)[:, None] * s], dim=1)
        # landmarks in the world = the keyframe's frame
        self._insert(T.apply(self.keyframe_pose, X * s), self.keyframe.desc, ok)
        prev = self.pose
        self.pose = T.compose(self.keyframe_pose, T.inverse(T21))
        self.vel = T.se3_log(T.relative(prev, self.pose))
        self.initialized = True
        info["initialized"] = True
        info["landmarks"] = self.n_landmarks
        return self.pose, torch.eye(6, device=self.device) * 1e-4, info

    def _track_frame(self, frame: FrameFeatures, info: dict, indices):
        guess = T.compose(self.pose, T.se3_exp(self.vel))  # constant velocity
        res, m = _track(self.map_xyz, self.map_desc, self.map_valid, frame, self.cam,
                        self.generator, guess, self.nndr, self.reproj_px,
                        min_inliers=self.min_inliers, indices=indices)
        n_match, n_inl, ok = torch.stack([m.valid.sum().to(torch.int32), res.num_inliers,
                                          res.success.to(torch.int32)]).tolist()
        info["matches"] = n_match
        info["inliers"] = n_inl
        if not ok:
            self.lost = True
            self.vel = torch.zeros((6,), device=self.device)
            self._window = []
            return None, torch.eye(6, device=self.device) * 9999.0, info
        self.lost = False
        self.vel = 0.7 * T.se3_log(T.relative(self.pose, res.transform)) + 0.3 * self.vel
        self.pose = res.transform
        # sliding-window local BA: recent poses and the landmarks jointly
        self._window.append((self.pose, m.idx, _norm_coords(frame.uv, self.cam),
                             m.valid & res.inliers))
        if len(self._window) > self.ba_window:
            self._window.pop(0)
        if len(self._window) >= 3:
            new_poses, self.map_xyz, _ = _local_ba(
                self.map_xyz, *(torch.stack([w[k] for w in self._window]) for k in range(4)))
            self._window = [(new_poses[i], *w[1:]) for i, w in enumerate(self._window)]
            self.pose = new_poses[-1]
        # keyframe policy and map growth: when the tracked inliers get
        # thin, triangulate fresh landmarks against the last keyframe and
        # rebase it
        if n_inl < 3 * self.min_inliers and self.keyframe is not None:
            Xw, ok_new, desc = _triangulate_new(self.keyframe, self.keyframe_pose, frame,
                                                self.pose, self.cam, self.nndr,
                                                self.min_parallax)
            self._insert(Xw, desc, ok_new)
            self.keyframe = frame
            self.keyframe_pose = self.pose
            info["landmarks"] = self.n_landmarks
        return self.pose, res.covariance, info

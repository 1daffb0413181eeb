"""Frame-to-frame (keyframe) visual odometry.

Port of ``rtabmap_tpu/odometry/f2f.py`` (the reference's ``OdometryF2F``):
each frame is registered against the last KEYFRAME (not a feature map)
from the constant-velocity guess, and the keyframe is refreshed when the
inliers fall below ``Odom/KeyFrameThr`` of the frame's valid features.
The RANSAC's sample indices come from a CPU ``torch.Generator`` (the JAX
twin splits its key once a frame) or are passed to ``process``
(``indices=``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import registration as REG


class OdometryF2F:
    """Host wrapper with the reference's ``process()`` semantics: a lost
    frame returns a None transform and covariance 9999. Runs on
    ``device`` (None = the CUDA card)."""

    def __init__(self, cam: C.CameraModel, params=None, seed: int = 0,
                 device: DeviceLike = None):
        from rtabmap_tpu_torch.utils.params import Parameters

        p = params or Parameters()
        self.device = resolve_device(device)
        self.cam = cam
        self.keyframe_thr = float(p["Odom/KeyFrameThr"])
        self.min_inliers = int(p["Vis/MinInliers"])
        self.nndr = float(p["Vis/CorNNDR"])
        self.reproj_px = float(p["Vis/PnPReprojError"])
        self.generator = torch.Generator().manual_seed(seed)   # RANSAC draws (CPU)
        self.reset()
        self.lost = False

    def process(self, frame: FrameFeatures, imu_quat=None, indices=None):
        """Track ``frame`` against the keyframe -> (pose, covariance, info).
        With ``imu_quat`` ([x,y,z,w]) the pose takes the IMU's roll and
        pitch. ``indices`` replaces RANSAC's drawn samples (the pair of
        ``ransac.pnp_sample_indices``)."""
        if self.keyframe is None:
            self.keyframe = frame
            self.keyframe_pose = self.pose
            return (self.pose, torch.eye(6, device=self.device) * 1e-6,
                    {"matches": 0, "inliers": 0, "keyframe": True})
        guess_pose = T.compose(self.pose, T.se3_exp(self.vel))
        guess = T.relative(self.keyframe_pose, guess_pose)
        res = REG.register_frames(self.keyframe, frame, self.cam, self.generator, guess=guess,
                                  nndr=self.nndr, reproj_px=self.reproj_px,
                                  min_inliers=self.min_inliers, indices=indices)
        # the one fetch of the frame
        ok, n_match, n_inl, n_feat = torch.stack(
            [res.valid.to(torch.int32), res.num_matches, res.num_inliers,
             frame.valid.sum().to(torch.int32)]).tolist()
        info = {"matches": n_match, "inliers": n_inl}
        if not ok:
            self.lost = True
            info["keyframe"] = False
            return None, torch.eye(6, device=self.device) * 9999.0, info
        self.lost = False
        new_pose = T.compose(self.keyframe_pose, res.transform)
        if imu_quat is not None:
            from rtabmap_tpu_torch.odometry.imu_filter import apply_gravity_alignment

            new_pose = apply_gravity_alignment(
                new_pose, torch.as_tensor(imu_quat, dtype=torch.float32, device=self.device))
        self.vel = 0.7 * T.se3_log(T.relative(self.pose, new_pose)) + 0.3 * self.vel
        self.pose = new_pose
        kf = n_inl < self.keyframe_thr * max(n_feat, 1)
        if kf:
            self.keyframe = frame
            self.keyframe_pose = new_pose
        info["keyframe"] = kf
        return new_pose, res.covariance, info

    def reset(self, pose=None):
        self.pose = (T.identity(device=self.device) if pose is None else
                     torch.as_tensor(np.asarray(pose, np.float32), device=self.device))
        self.vel = torch.zeros((6,), device=self.device)
        self.keyframe: Optional[FrameFeatures] = None
        self.keyframe_pose = self.pose

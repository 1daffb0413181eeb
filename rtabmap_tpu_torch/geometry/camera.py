"""Pinhole camera model: intrinsics + projection / backprojection.

Port of the parts of ``rtabmap_tpu/geometry/camera.py`` that the
appearance-only, RGB-D and stereo paths and the renderer reach: the
pinhole model, the ideal (pre-rectified) stereo pair and the disparity
conversions. The distortion model, rectification and the stereo yaml come
with the calibration slice. Intrinsics are host floats
holding float32 values, so device code folds them in as scalars.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class CameraModel(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0
    dist: Optional[np.ndarray] = None             # k1,k2,p1,p2,k3 (plumb bob)
    local_transform: Optional[np.ndarray] = None  # (3,4) camera in base frame

    @staticmethod
    def make(fx, fy, cx, cy, width=0, height=0, dist=None, local_transform=None):
        f32 = lambda v: float(np.float32(v))
        return CameraModel(
            f32(fx), f32(fy), f32(cx), f32(cy), int(width), int(height),
            None if dist is None else np.asarray(dist, np.float32),
            None if local_transform is None else np.asarray(local_transform, np.float32),
        )


class StereoCameraModel(NamedTuple):
    """A rectified stereo pair: both cameras share the intrinsics; the right
    one sits ``baseline`` metres along the left one's x axis. ``R``/``T``
    (the left->right extrinsics of an unrectified pair) stay None here."""
    left: CameraModel
    right: CameraModel
    baseline: float                  # metres
    R: Optional[np.ndarray] = None   # (3,3)
    T: Optional[np.ndarray] = None   # (3,)

    @staticmethod
    def make(fx, fy, cx, cy, baseline, width=0, height=0, local_transform=None):
        cam = CameraModel.make(fx, fy, cx, cy, width, height, local_transform=local_transform)
        return StereoCameraModel(cam, cam, float(np.float32(baseline)))


def disparity_to_depth(disparity: torch.Tensor, stereo: StereoCameraModel) -> torch.Tensor:
    """fx * baseline / disparity where the disparity is positive, else 0."""
    valid = disparity > 0
    fb = float(np.float32(stereo.left.fx) * np.float32(stereo.baseline))
    return torch.where(valid, fb / torch.where(valid, disparity, torch.ones_like(disparity)),
                       torch.zeros_like(disparity))


def depth_to_disparity(depth: torch.Tensor, stereo: StereoCameraModel) -> torch.Tensor:
    """fx * baseline / depth where the depth is positive, else 0."""
    return disparity_to_depth(depth, stereo)


def project(pts_cam: torch.Tensor, cam: CameraModel):
    """Camera-frame 3D points (...,N,3) -> pixels (...,N,2) + depth (...,N)."""
    z = pts_cam[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    u = pts_cam[..., 0] / zs * cam.fx + cam.cx
    v = pts_cam[..., 1] / zs * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(uv: torch.Tensor, depth: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """Pixels (...,N,2) + depth (...,N) -> camera-frame 3D (...,N,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_image(uv: torch.Tensor, width, height, border: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= border) & (uv[..., 0] < width - border)
            & (uv[..., 1] >= border) & (uv[..., 1] < height - border))

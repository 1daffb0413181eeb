"""Pinhole camera model: intrinsics + projection / backprojection.

Port of the parts of ``rtabmap_tpu/geometry/camera.py`` that the
appearance-only path and the renderer reach. Intrinsics are host floats
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

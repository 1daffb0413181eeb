"""Rigid 3x4 transforms: the host ``np_*`` helpers and tensor accessors.

Port of the parts of ``rtabmap_tpu/geometry/transform.py`` that the
appearance-only engine and the renderer reach. Poses are (3,4) [R | t].
"""
from __future__ import annotations

import numpy as np
import torch


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    eye = torch.zeros((3, 4), dtype=dtype, device=device)
    eye[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(*batch_shape, 3, 4)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


# Host numpy forms for single (3,4) poses: per-tick pose bookkeeping stays
# on the host.

def np_compose(A, B):
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    out = np.empty((3, 4))
    out[:, :3] = A[:, :3] @ B[:, :3]
    out[:, 3] = A[:, :3] @ B[:, 3] + A[:, 3]
    return out


def np_inverse(A):
    A = np.asarray(A, np.float64)
    out = np.empty((3, 4))
    out[:, :3] = A[:, :3].T
    out[:, 3] = -A[:, :3].T @ A[:, 3]
    return out


def np_relative(A, B):
    """inverse(A) o B for single (3,4) host poses."""
    return np_compose(np_inverse(A), B)


def np_translation_norm(A) -> float:
    return float(np.linalg.norm(np.asarray(A)[:3, 3]))


def np_rotation_angle(A) -> float:
    """Geodesic rotation angle, atan2 form (float-accurate near 0)."""
    R = np.asarray(A, np.float64)[:3, :3]
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(0.5 * np.linalg.norm(vee),
                            np.clip((tr - 1.0) * 0.5, -1.0, 1.0)))


def np_to_xyzrpy(A):
    A = np.asarray(A, np.float64)
    R, t = A[:3, :3], A[:3, 3]
    p = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    r = np.arctan2(R[2, 1], R[2, 2])
    yw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([t[0], t[1], t[2], r, p, yw])

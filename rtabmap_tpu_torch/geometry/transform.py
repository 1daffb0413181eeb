"""SE(3) / SO(3) batched geometry and the host ``np_*`` helpers.

Port of ``rtabmap_tpu/geometry/transform.py``, with the quaternion and
Euler conversions the pose files use. A pose is a
``(..., 3, 4)`` tensor ``[R | t]``, batch dims leading. Tangent vectors are
``(..., 6)`` ``[rho(3), phi(3)]``, translation first. The functions are
pure (no in-place ops), so ``torch.func.jacfwd``/``vmap`` go through them.
"""
from __future__ import annotations

import numpy as np
import torch


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    eye = torch.zeros((3, 4), dtype=dtype, device=device)
    eye[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(*batch_shape, 3, 4)


_EPS = 1e-9


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pose(s) from rotation (...,3,3) and translation (...,3)."""
    return torch.cat([R, t[..., None]], dim=-1)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 3x4 rigid transforms (batched)."""
    Ra, ta = rotation(A), translation(A)
    return from_rt(Ra @ rotation(B), _mv(Ra, translation(B)) + ta)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_rt(Rt, -_mv(Rt, translation(T)))


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (...,3,4) applied to pts (...,N,3) -> (...,N,3)."""
    return (torch.einsum("...ij,...nj->...ni", rotation(T), pts)
            + translation(T)[..., None, :])


def relative(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 @ B: the motion taking frame A to frame B."""
    return compose(inverse(A), B)


# ----------------------------------------------------------------- SO(3)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_hat(phi: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues (...,3) -> (...,3,3), Taylor-blended near phi = 0."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = so3_hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,3), with the small-angle and near-pi branches of
    the JAX twin, every branch evaluated on guarded inputs (finite forward
    derivatives at the identity)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_sq = (vee * vee).sum(-1) * 0.25
    sin_t = torch.sqrt(torch.clamp_min(sin_sq, 1e-24))
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    sin_safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    generic = scale[..., None] * vee
    near_pi = theta > np.pi - 1e-3
    B = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    denom = torch.where(near_pi, 1.0 - cos_t, torch.ones_like(cos_t))[..., None]
    axis_sq = torch.clamp_min((diag - cos_t[..., None]) / denom, 0.0)
    axis = torch.sqrt(torch.clamp_min(axis_sq, 1e-24))
    axis = axis * torch.where(vee >= 0, 1.0, -1.0)
    axis = axis / torch.clamp_min(torch.linalg.norm(axis, dim=-1, keepdim=True), _EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], generic)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V such that the se3_exp translation is V @ rho."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = so3_hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS))
    small = theta2 < 1e-8
    half = theta * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), _EPS))
        / torch.clamp_min(theta2, _EPS))
    K = so3_hat(phi)
    return _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


# ----------------------------------------------------------------- SE(3)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) [rho, phi] -> (...,3,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return from_rt(so3_exp(phi), _mv(_so3_left_jacobian(phi), rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,6) [rho, phi]."""
    phi = so3_log(rotation(T))
    rho = _mv(_so3_left_jacobian_inv(phi), translation(T))
    return torch.cat([rho, phi], dim=-1)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction T * exp(xi)."""
    return compose(T, se3_exp(xi))


def retract_left(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction exp(xi) * T."""
    return compose(se3_exp(xi), T)


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation onto SO(3) through its SVD (batched)."""
    R = rotation(T)
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones((*det.shape, 2), dtype=R.dtype, device=R.device),
                   det[..., None]], dim=-1)
    return from_rt(((U * D[..., None, :]) @ Vt).to(T.dtype), translation(T))


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle in radians, atan2(|vee|/2, (tr-1)/2)
    (float32-accurate at small angles, unlike arccos)."""
    R = T[..., :3, :3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = 0.5 * torch.linalg.norm(vee, dim=-1)
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.atan2(sin_t, cos_t)


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(translation(T), dim=-1)


def is_identity(T: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    return (translation_norm(T) < tol) & (rotation_angle(T) < tol)


def to_matrix4(T: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,4,4) homogeneous."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    return torch.cat([T, bottom.expand(*T.shape[:-2], 1, 4)], dim=-2)


def interpolate(A: torch.Tensor, B: torch.Tensor, alpha) -> torch.Tensor:
    """Pose slerp + lerp: A..B at fraction ``alpha`` (broadcastable)."""
    xi = se3_log(relative(A, B))
    a = torch.as_tensor(alpha, dtype=xi.dtype, device=xi.device)
    return compose(A, se3_exp(xi * a[..., None]))


def to_quaternion(T: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,4) quaternion [x,y,z,w]: of the four constructions
    the one with the largest pivot (first on ties, as ``argmax``)."""
    R = rotation(T)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        q = torch.sqrt(torch.clamp_min(x, _EPS)) * 0.5
        return q, 0.25 / torch.clamp_min(q, _EPS)

    qw0, s0 = half_sqrt(1.0 + tr)
    c0 = torch.stack([(m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0, qw0], -1)
    qx1, s1 = half_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([qx1, (m01 + m10) * s1, (m02 + m20) * s1, (m21 - m12) * s1], -1)
    qy2, s2 = half_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10) * s2, qy2, (m12 + m21) * s2, (m02 - m20) * s2], -1)
    qz3, s3 = half_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20) * s3, (m12 + m21) * s3, qz3, (m10 - m01) * s3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)                   # (...,4,4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)


def from_quaternion(q: torch.Tensor, t: torch.Tensor = None) -> torch.Tensor:
    """Quaternion [x,y,z,w] (and a translation) -> (...,3,4)."""
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    if t is None:
        t = torch.zeros((*q.shape[:-1], 3), dtype=q.dtype, device=q.device)
    return from_rt(R, t)


def from_xyzrpy(xyzrpy: torch.Tensor) -> torch.Tensor:
    """(...,6) [x,y,z,roll,pitch,yaw] -> (...,3,4), ZYX Euler angles."""
    x, y, z = xyzrpy[..., 0], xyzrpy[..., 1], xyzrpy[..., 2]
    r, p, yw = xyzrpy[..., 3], xyzrpy[..., 4], xyzrpy[..., 5]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(yw), torch.sin(yw)
    R = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], dim=-2)
    return from_rt(R, torch.stack([x, y, z], dim=-1))


def to_xyzrpy(T: torch.Tensor) -> torch.Tensor:
    R, t = rotation(T), translation(T)
    p = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    r = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.cat([t, torch.stack([r, p, yw], dim=-1)], dim=-1)


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

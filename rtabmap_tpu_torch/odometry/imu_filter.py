"""IMU orientation filters: Madgwick and complementary AHRS.

Port of ``rtabmap_tpu/odometry/imu_filter.py`` (the reference's
imufilter module, which gravity-aligns odometry): one-sample update
functions on quaternions [x,y,z,w], a sequential integration over a
batch of samples, and the roll/pitch alignment of a pose. Tensors stay on
the device of their inputs.
"""
from __future__ import annotations

import torch

from rtabmap_tpu_torch.geometry import transform as T


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def _normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-9)


def madgwick_update(q, gyro, accel, dt, beta: float = 0.1) -> torch.Tensor:
    """One Madgwick IMU update (gyro rad/s, accel m/s^2, dt s): the gyro
    rate plus a gradient step of size ``beta`` on R(q)^T z - a."""
    omega = torch.cat([gyro, torch.zeros_like(gyro[..., :1])], dim=-1)
    q_dot = 0.5 * _quat_mul(q, omega)
    a = _unit(accel)
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    f = torch.stack([
        2 * (qx * qz - qw * qy) - a[..., 0],
        2 * (qw * qx + qy * qz) - a[..., 1],
        2 * (0.5 - qx * qx - qy * qy) - a[..., 2],
    ], dim=-1)
    zero = torch.zeros_like(qx)
    # J[i,:] = d(f1, f2, f3)/dq_i in the state order [x,y,z,w]
    J = torch.stack([
        torch.stack([2 * qz, 2 * qw, -4 * qx], -1),
        torch.stack([-2 * qw, 2 * qz, -4 * qy], -1),
        torch.stack([2 * qx, 2 * qy, zero], -1),
        torch.stack([-2 * qy, 2 * qx, zero], -1),
    ], dim=-2)
    grad = _normalize((J * f[..., None, :]).sum(-1))
    return _normalize(q + (q_dot - beta * grad) * dt)


def complementary_update(q, gyro, accel, dt, alpha: float = 0.02) -> torch.Tensor:
    """Gyro integration, then a small rotation (``alpha``) about
    g_body x a, applied in the body frame. That is the twin's correction:
    it turns the predicted gravity away from the measured one, so under a
    sustained tilt the estimate drifts (roll reaches pi within a few
    seconds); the port keeps the twin's result."""
    omega = torch.cat([gyro, torch.zeros_like(gyro[..., :1])], dim=-1)
    q_pred = _normalize(q + 0.5 * _quat_mul(q, omega) * dt)
    a = _unit(accel)
    qx, qy, qz, qw = q_pred[..., 0], q_pred[..., 1], q_pred[..., 2], q_pred[..., 3]
    g_body = torch.stack([
        2 * (qx * qz - qw * qy),
        2 * (qw * qx + qy * qz),
        qw * qw - qx * qx - qy * qy + qz * qz,
    ], dim=-1)
    axis = torch.linalg.cross(g_body, a)
    corr = torch.cat([alpha * 0.5 * axis, torch.ones_like(a[..., :1])], dim=-1)
    return _normalize(_quat_mul(q_pred, _normalize(corr)))


def integrate_imu(gyro_seq, accel_seq, dt_seq, q0=None, method: str = "madgwick",
                  beta: float = 0.1, alpha: float = 0.02) -> torch.Tensor:
    """Integrate a sample sequence (N,3), (N,3), (N,) from ``q0`` (identity
    by default), one update a sample: (N,4) quaternions."""
    if q0 is None:
        q0 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=gyro_seq.dtype, device=gyro_seq.device)
    q, out = q0, []
    for g, a, dt in zip(gyro_seq, accel_seq, dt_seq):
        q = (madgwick_update(q, g, a, dt, beta) if method == "madgwick"
             else complementary_update(q, g, a, dt, alpha))
        out.append(q)
    return torch.stack(out)


def gravity_aligned_correction(q: torch.Tensor) -> torch.Tensor:
    """The roll/pitch-only rotation of orientation ``q`` (yaw and
    translation removed)."""
    rpy = T.to_xyzrpy(T.from_quaternion(q))
    zero = torch.zeros_like(rpy[..., 0])
    rp = torch.stack([zero, zero, zero, rpy[..., 3], rpy[..., 4], zero], dim=-1)
    return T.from_xyzrpy(rp)


def apply_gravity_alignment(pose: torch.Tensor, imu_quat: torch.Tensor) -> torch.Tensor:
    """The pose with its roll and pitch replaced by the IMU's, its yaw and
    translation kept (the AHRS owns roll/pitch, vision yaw and position)."""
    rpy = T.to_xyzrpy(pose)
    rpy_imu = T.to_xyzrpy(T.from_quaternion(imu_quat))
    return T.from_xyzrpy(torch.cat([rpy[..., :3], rpy_imu[..., 3:5], rpy[..., 5:]], dim=-1))

"""Constant-velocity Kalman filter on a 6-DoF pose, and a particle filter.

Port of ``rtabmap_tpu/odometry/motion_filter.py`` (the reference's
odometry motion filtering: a constant-velocity linear Kalman filter over
[x y z roll pitch yaw, their velocities], and per-axis particle filters).
Pure functions over small tensors. The particle filter's random numbers
come from a ``torch.Generator`` or are passed in (``noise=``,
``offset=``), so a parity test can inject the JAX twin's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtabmap_tpu_torch.geometry import transform as T


class KalmanState(NamedTuple):
    x: torch.Tensor  # (12,)
    P: torch.Tensor  # (12,12)


def init_kalman(process_noise: float = 0.001, device=None) -> KalmanState:
    return KalmanState(x=torch.zeros((12,), device=device),
                       P=torch.eye(12, device=device) * 1.0)


def kalman_predict(state: KalmanState, dt: float, q: float = 0.001) -> KalmanState:
    """x' = F x, P' = F P F^T + Q with the piecewise-constant-acceleration
    process noise."""
    dev = state.x.device
    eye6 = torch.eye(6, device=dev)
    F = torch.eye(12, device=dev)
    F[:6, 6:] = eye6 * dt
    Q = torch.zeros((12, 12), device=dev)
    Q[:6, :6] = eye6 * (q * dt ** 3 / 3.0)
    Q[:6, 6:] = eye6 * (q * dt ** 2 / 2.0)
    Q[6:, :6] = eye6 * (q * dt ** 2 / 2.0)
    Q[6:, 6:] = eye6 * (q * dt)
    return KalmanState(F @ state.x, F @ state.P @ F.T + Q)


def kalman_update(state: KalmanState, meas_pose6, meas_cov6) -> KalmanState:
    """Measurement = absolute pose (x y z roll pitch yaw); the angular
    innovation is wrapped to [-pi, pi]."""
    dev = state.x.device
    H = torch.zeros((6, 12), device=dev)
    H[:, :6] = torch.eye(6, device=dev)
    innov = torch.as_tensor(meas_pose6, dtype=torch.float32, device=dev) - H @ state.x
    ang = innov[3:]
    innov = torch.cat([innov[:3], torch.atan2(torch.sin(ang), torch.cos(ang))])
    S = H @ state.P @ H.T + torch.as_tensor(meas_cov6, dtype=torch.float32, device=dev)
    K = state.P @ H.T @ torch.linalg.inv(S)
    return KalmanState(state.x + K @ innov, (torch.eye(12, device=dev) - K @ H) @ state.P)


def predicted_pose(state: KalmanState) -> torch.Tensor:
    return T.from_xyzrpy(state.x[:6])


def predicted_velocity(state: KalmanState) -> torch.Tensor:
    return state.x[6:]


# ------------------------------------------------------------ particle filter


class ParticleState(NamedTuple):
    particles: torch.Tensor  # (P, D) one filter per measured axis
    weights: torch.Tensor    # (P,)


def init_particles(generator: Optional[torch.Generator] = None, n: int = 400, dim: int = 6,
                   sigma: float = 0.1, device=None,
                   noise: Optional[torch.Tensor] = None) -> ParticleState:
    """``sigma`` x standard normal particles; ``noise`` (n, dim) replaces
    the draw."""
    if noise is None:
        noise = torch.randn((n, dim), generator=generator)
    return ParticleState(particles=sigma * noise.to(device),
                         weights=torch.full((n,), 1.0 / n, device=device))


def particle_step(state: ParticleState, meas, generator: Optional[torch.Generator] = None,
                  noise: float = 0.01, lambda_meas: float = 100.0,
                  walk: Optional[torch.Tensor] = None, offset: Optional[float] = None
                  ) -> Tuple[ParticleState, torch.Tensor]:
    """Predict (random walk), weight by a Gaussian likelihood around the
    measurement, systematic resampling; returns (state, filtered estimate).
    ``walk`` (P, D) standard normals and ``offset`` in [0, 1) replace the
    draws."""
    parts = state.particles
    n = parts.shape[0]
    dev = parts.device
    if walk is None:
        walk = torch.randn(parts.shape, generator=generator)
    if offset is None:
        offset = float(torch.rand((), generator=generator))
    parts = parts + noise * walk.to(dev)
    meas = torch.as_tensor(meas, dtype=parts.dtype, device=dev)
    d2 = ((parts - meas[None, :]) ** 2).sum(-1)
    w = torch.exp(-0.5 * lambda_meas * d2)
    w = w / torch.clamp(w.sum(), min=1e-30)
    est = (parts * w[:, None]).sum(0)
    positions = (torch.arange(n, device=dev) + offset) / n
    idx = torch.searchsorted(torch.cumsum(w, 0), positions)
    parts = parts[idx.clamp(0, n - 1)]
    return ParticleState(parts, torch.full((n,), 1.0 / n, device=dev)), est

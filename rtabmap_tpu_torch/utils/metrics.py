"""Trajectory metrics: SE(3)-aligned ATE RMSE and relative pose error.

Port of ``align_umeyama``, ``ate_rmse``, ``gt_error_stats``, ``rpe`` and
``summarize`` from ``rtabmap_tpu/utils/metrics.py`` (the reference's
graph::calcRMSE family).
Host numpy in float64; ``rpe`` composes the per-step relative poses in
float32 tensors as the JAX twin does. Poses may be arrays or tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import to_numpy as _host
from rtabmap_tpu_torch.geometry import transform as T


def align_umeyama(est_t, gt_t, with_scale: bool = False):
    """Closed-form SE(3) (+scale) alignment est -> gt of (N,3) translations:
    (s, R (3,3), t (3,)) minimizing ||gt - (s R est + t)||^2."""
    est = _host(est_t).astype(np.float64)
    gt = _host(gt_t).astype(np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(ec.T @ gc / est.shape[0])
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    s = 1.0
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(S) @ D) / var_e) if var_e > 0 else 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_poses, gt_poses, with_scale: bool = False) -> float:
    """SE(3)-aligned translational RMSE (meters) of (N,3,4) poses."""
    est_t = _host(est_poses)[:, :3, 3]
    gt_t = _host(gt_poses)[:, :3, 3]
    s, R, t = align_umeyama(est_t, gt_t, with_scale)
    err = np.linalg.norm((s * (R @ est_t.T)).T + t - gt_t, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_poses, gt_poses, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame gaps of ``delta``: (translation RMSE
    m, rotation RMSE rad)."""
    est = torch.as_tensor(_host(est_poses), dtype=torch.float32)
    gt = torch.as_tensor(_host(gt_poses), dtype=torch.float32)
    n = est.shape[0] - delta
    e = T.relative(T.relative(gt[:n], gt[delta:]), T.relative(est[:n], est[delta:]))
    te = torch.linalg.norm(e[:, :3, 3], dim=-1).numpy()
    re = T.rotation_angle(e).numpy()
    return (float(np.sqrt(np.mean(np.square(te)))),
            float(np.sqrt(np.mean(np.square(re)))))


def summarize(est_poses, gt_poses) -> Dict[str, float]:
    out = {"ate_rmse": ate_rmse(est_poses, gt_poses),
           "ate_rmse_scaled": ate_rmse(est_poses, gt_poses, with_scale=True)}
    out["rpe_trans"], out["rpe_rot"] = rpe(est_poses, gt_poses)
    return out


def gt_error_stats(est_poses, gt_poses) -> Dict[str, float]:
    """graph::calcRMSE parity (the Gt/* statistics): anchor the estimate at
    the first ground-truth pose (not Umeyama), then the translational and
    rotational error statistics in metres and degrees."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt))
    if n == 0:
        return {}
    est, gt = est[:n], gt[:n]

    def to44(P):
        M = np.tile(np.eye(4), (P.shape[0], 1, 1))
        M[:, :3, :] = P
        return M

    E, G = to44(est), to44(gt)
    A = (G[0] @ np.linalg.inv(E[0]))[None] @ E
    D = np.linalg.inv(G) @ A
    t_err = np.linalg.norm(D[:, :3, 3], axis=1)
    r_err = np.degrees(np.arccos(np.clip((np.trace(D[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                                         -1, 1)))
    out = {"Gt/Localization linear error/m": float(t_err[-1]),
           "Gt/Localization angular error/deg": float(r_err[-1])}
    for name, err, unit in (("Translational", t_err, "m"), ("Rotational", r_err, "deg")):
        out.update({f"Gt/{name} rmse/{unit}": float(np.sqrt((err ** 2).mean())),
                    f"Gt/{name} mean/{unit}": float(err.mean()),
                    f"Gt/{name} median/{unit}": float(np.median(err)),
                    f"Gt/{name} std/{unit}": float(err.std()),
                    f"Gt/{name} min/{unit}": float(err.min()),
                    f"Gt/{name} max/{unit}": float(err.max())})
    return out

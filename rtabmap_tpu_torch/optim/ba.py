"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Port of ``bundle_adjust`` and ``outlier_mask`` from
``rtabmap_tpu/optim/ba.py`` (the reference's ``Optimizer::optimizeBA``
as F2M local bundle adjustment uses it): per-observation residuals and
Jacobians, camera blocks summed by a one-hot product, point blocks by
``index_add_`` (atomic adds on the card, so sums agree with the JAX twin
within rounding, not bit for bit), the point blocks inverted in closed
form, the camera-point cross term kept dense as (Nc,Np,6,3), and the
reduced camera system solved densely. Fixed iteration count, an LM step
kept only when the cost decreases. ``bundle_adjust_large`` is the
implicit-Schur form for whole maps (global BA): the reduced camera system
is never formed, each of its products is two observation-wise Jacobian
contractions and scatter-adds, solved by Jacobi-preconditioned CG for a
fixed ``cg_iters``. Its two fixed-length loops are plain Python loops.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import linalg as L3


class BAProblem(NamedTuple):
    poses: torch.Tensor       # (Nc,3,4) world->camera extrinsics
    points: torch.Tensor      # (Np,3) world points
    cam_idx: torch.Tensor     # (No,) int
    pt_idx: torch.Tensor      # (No,) int
    uv: torch.Tensor          # (No,2) normalized image coords
    valid: torch.Tensor       # (No,)
    fixed_cams: torch.Tensor  # (Nc,) bool gauge/anchor cameras


def _residual_jac(Tcw: torch.Tensor, pt: torch.Tensor, uv: torch.Tensor):
    """Batched over observations: Tcw (No,3,4), pt (No,3), uv (No,2) ->
    residual (No,2), d r / d twist (No,2,6) for a left perturbation of Tcw,
    d r / d point (No,2,3), depth (No,)."""
    R = T.rotation(Tcw)
    pc = torch.einsum("oij,oj->oi", R, pt) + T.translation(Tcw)
    z = torch.where(pc[:, 2].abs() > 1e-6, pc[:, 2], torch.full_like(pc[:, 2], 1e-6))
    r = pc[:, :2] / z[:, None] - uv
    x, y = pc[:, 0], pc[:, 1]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    dp = torch.stack([torch.stack([iz, zero, -x * iz2], -1),
                      torch.stack([zero, iz, -y * iz2], -1)], -2)          # (No,2,3)
    eye = torch.eye(3, dtype=pt.dtype, device=pt.device).expand(pt.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -T.so3_hat(pc)], dim=-1)                      # (No,3,6)
    return r, dp @ dpc_dxi, dp @ R, pc[:, 2]


def _cam_reduce(ci: torch.Tensor, vals: torch.Tensor, n_cams: int) -> torch.Tensor:
    """Sum per-observation values into camera bins by a one-hot f32 product
    (the camera count is small)."""
    onehot = (ci[None, :] == torch.arange(n_cams, device=ci.device)[:, None]).to(vals.dtype)
    return (onehot @ vals.reshape(vals.shape[0], -1)).reshape((n_cams,) + vals.shape[1:])


def _scatter_add(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def _linearize(problem: BAProblem, poses, points, huber: float):
    r, Jc, Jp, depth = _residual_jac(poses[problem.cam_idx], points[problem.pt_idx],
                                     problem.uv)
    ok = problem.valid & (depth > 0.01)
    nrm = torch.linalg.norm(r, dim=-1)
    w = torch.where(nrm <= huber, torch.ones_like(nrm),
                    huber / torch.clamp_min(nrm, 1e-12)) * ok
    return r, Jc, Jp, w


def _cost(problem: BAProblem, poses, points, huber: float) -> torch.Tensor:
    r, _, _, w = _linearize(problem, poses, points, huber)
    return (w[:, None] * r * r).sum()


def _normal_blocks(problem: BAProblem, poses, points, huber: float, damping: float):
    """One linearization: (residuals, Jc, Jp, Huber-weighted Jc and Jp, the
    damped camera blocks B (Nc,6,6) with the fixed cameras pinned, the
    inverted damped point blocks (Np,3,3), bc (Nc,6), bp (Np,3))."""
    Nc, Np = poses.shape[0], points.shape[0]
    dt, dev = points.dtype, points.device
    ci, pi = problem.cam_idx.long(), problem.pt_idx.long()
    r, Jc, Jp, w = _linearize(problem, poses, points, huber)
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    B = _cam_reduce(ci, torch.einsum("ori,orj->oij", Jcw, Jc), Nc)
    Cb = _scatter_add(Np, pi, torch.einsum("ori,orj->oij", Jpw, Jp))
    bc = _cam_reduce(ci, torch.einsum("ori,or->oi", Jcw, r), Nc)
    bp = _scatter_add(Np, pi, torch.einsum("ori,or->oi", Jpw, r))
    fix = problem.fixed_cams.to(dt) * 1e8
    B = B + torch.eye(6, dtype=dt, device=dev)[None] * (damping + fix[:, None, None])
    Cinv = L3.inv3(Cb + torch.eye(3, dtype=dt, device=dev)[None] * damping)
    return r, Jc, Jp, Jcw, B, Cinv, bc, bp


def _lm_accept(problem: BAProblem, poses, points, cost, dxc, dxp, huber: float):
    """Apply the step (the fixed cameras held) and keep it only if the cost
    fell."""
    dxc = torch.where(problem.fixed_cams[:, None], torch.zeros_like(dxc), dxc)
    new_poses = T.retract_left(poses, dxc)
    new_points = points + dxp
    new_cost = _cost(problem, new_poses, new_points, huber)
    better = new_cost < cost
    return (torch.where(better, new_poses, poses), torch.where(better, new_points, points),
            torch.where(better, new_cost, cost))


def bundle_adjust(problem: BAProblem, iters: int = 10, damping: float = 1e-3,
                  huber: float = 0.01) -> Tuple[BAProblem, torch.Tensor]:
    """LM with the Schur complement. Returns (refined problem, final cost)."""
    Nc, Np = problem.poses.shape[0], problem.points.shape[0]
    dt, dev = problem.points.dtype, problem.points.device
    ci, pi = problem.cam_idx.long(), problem.pt_idx.long()
    poses, points = problem.poses, problem.points
    cost = _cost(problem, poses, points, huber)
    for _ in range(iters):
        _, _, Jp, JcT_w, B, Cinv, bc, bp = _normal_blocks(problem, poses, points, huber, damping)
        E = _scatter_add(Nc * Np, ci * Np + pi,
                         torch.einsum("ori,orj->oij", JcT_w, Jp)).reshape(Nc, Np, 6, 3)
        ECE = torch.einsum("apik,pkl,bpjl->aibj", E, Cinv, E)
        S = torch.zeros((Nc, 6, Nc, 6), dtype=dt, device=dev)
        ar = torch.arange(Nc, device=dev)
        S[ar, :, ar, :] = B
        S = (S - ECE).reshape(6 * Nc, 6 * Nc)
        v = bc - torch.einsum("apik,pkl,pl->ai", E, Cinv, bp)
        dxc = -torch.linalg.solve(S + 1e-8 * torch.eye(6 * Nc, dtype=dt, device=dev),
                                  v.reshape(-1)).reshape(Nc, 6)
        dxp = -torch.einsum("pkl,pl->pk", Cinv, bp + torch.einsum("apik,ai->pk", E, dxc))
        poses, points, cost = _lm_accept(problem, poses, points, cost, dxc, dxp, huber)
    return problem._replace(poses=poses, points=points), cost


def outlier_mask(problem: BAProblem, reproj_thr: float) -> torch.Tensor:
    """Observations whose residual exceeds the threshold after BA, or
    whose point is behind (or at) the camera (sbaOutliers pruning)."""
    r, _, _, depth = _residual_jac(problem.poses[problem.cam_idx],
                                   problem.points[problem.pt_idx], problem.uv)
    return problem.valid & ((torch.linalg.norm(r, dim=-1) > reproj_thr) | (depth <= 0.01))


def bundle_adjust_large(problem: BAProblem, iters: int = 10, cg_iters: int = 30,
                        damping: float = 1e-3, huber: float = 0.01
                        ) -> Tuple[BAProblem, torch.Tensor]:
    """Implicit-Schur LM for map-scale problems: S = B - E C^-1 E^T is
    applied, never built, so memory is O(No + Nc + Np). Returns (refined
    problem, final cost)."""
    Nc, Np = problem.poses.shape[0], problem.points.shape[0]
    dt, dev = problem.points.dtype, problem.points.device
    ci, pi = problem.cam_idx.long(), problem.pt_idx.long()
    poses, points = problem.poses, problem.points
    cost = _cost(problem, poses, points, huber)
    for _ in range(iters):
        _, _, Jp, Jcw, B, Cinv, bc, bp = _normal_blocks(problem, poses, points, huber, damping)

        def e_t_x(x_c):
            """E^T x (Np,3): per observation Jp^T W Jc x[cam], summed by point."""
            y = torch.einsum("ori,oi->or", Jcw, x_c[ci])
            return _scatter_add(Np, pi, torch.einsum("ori,or->oi", Jp, y))

        def e_u(u_p):
            """E u (Nc,6): per observation Jc^T W Jp u[point], summed by camera."""
            y = torch.einsum("ori,oi->or", Jp, u_p[pi])
            return _cam_reduce(ci, torch.einsum("ori,or->oi", Jcw, y), Nc)

        def s_mv(x_c):
            u = torch.einsum("pkl,pl->pk", Cinv, e_t_x(x_c))
            return torch.einsum("cij,cj->ci", B, x_c) - e_u(u)

        v = bc - e_u(torch.einsum("pkl,pl->pk", Cinv, bp))
        minv = 1.0 / torch.clamp_min(torch.diagonal(B, dim1=1, dim2=2), 1e-12)
        x = torch.zeros((Nc, 6), dtype=dt, device=dev)
        rr, p = v, minv * v
        rz = (v * p).sum()
        for _ in range(cg_iters):
            Ap = s_mv(p)
            alpha = rz / torch.clamp_min((p * Ap).sum(), 1e-12)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = minv * rr
            rz_new = (rr * z).sum()
            p = z + rz_new / torch.clamp_min(rz, 1e-12) * p
            rz = rz_new
        # the point step takes the camera step before the fixed cameras are held
        dxp = -torch.einsum("pkl,pl->pk", Cinv, bp + e_t_x(-x))
        poses, points, cost = _lm_accept(problem, poses, points, cost, -x, dxp, huber)
    return problem._replace(poses=poses, points=points), cost

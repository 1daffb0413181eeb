"""SE(3) pose-graph optimization: Levenberg-Marquardt on a dense system.

Port of the dense path of ``rtabmap_tpu/optim/pose_graph.py`` (the
reference's g2o/GTSAM ``Optimizer`` role: SE(3) edges with 6x6
information, Huber and DCS robust kernels, pose priors, a fixed root).
Residuals and their per-edge Jacobians come in closed form (the inverse
right Jacobian of SE(3) and the adjoint; the JAX twin differentiates the
same residual by forward-mode autodiff); the normal system is assembled dense and solved by a
float32 Cholesky, with the LM step accepted on the robust objective and
the DCS anneal driven by the count of accepted steps. The iterations are a
Python loop of device operations with no host sync. The matrix-free PCG
solver for graphs past ``dense_threshold`` nodes is later work.
``solve_diagnostics`` gives the engine's post-solve edge statistics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import transform as T


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph. Unary priors (P entries, may be 0) have
    the residual log(meas^-1 * T_i)."""

    poses: torch.Tensor       # (N,3,4)
    node_valid: torch.Tensor  # (N,) bool
    edges_from: torch.Tensor  # (E,) int64
    edges_to: torch.Tensor    # (E,) int64
    edges_meas: torch.Tensor  # (E,3,4) T_from_to measurement
    edges_info: torch.Tensor  # (E,6,6) information matrices
    edge_valid: torch.Tensor  # (E,) bool
    root: int                 # gauge-fixed node
    priors_idx: torch.Tensor  # (P,) node ids
    priors_meas: torch.Tensor  # (P,3,4)
    priors_info: torch.Tensor  # (P,6,6)
    prior_valid: torch.Tensor  # (P,) bool


def make_graph(poses, edges_from, edges_to, edges_meas, edges_info=None,
               node_valid=None, edge_valid=None, root: int = 0,
               priors_idx=None, priors_meas=None, priors_info=None,
               prior_valid=None, device: DeviceLike = None) -> PoseGraph:
    """Inputs may be tensors or arrays. ``device`` None means the device of
    ``poses`` when it is a tensor, else the CUDA card."""
    if device is None and isinstance(poses, torch.Tensor):
        dev = poses.device
    else:
        dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    poses = torch.as_tensor(poses, **f32)
    N = poses.shape[0]
    edges_from = torch.as_tensor(edges_from, **i64)
    E = edges_from.shape[0]
    if edges_info is None:
        edges_info = torch.eye(6, **f32).expand(E, 6, 6)
    P = 0 if priors_idx is None else len(priors_idx)
    if priors_idx is None:
        priors_idx = torch.zeros((0,), **i64)
        priors_meas = torch.zeros((0, 3, 4), **f32)
        priors_info = torch.zeros((0, 6, 6), **f32)
    flag = lambda v, n: (torch.ones((n,), dtype=torch.bool, device=dev) if v is None
                         else torch.as_tensor(v, dtype=torch.bool, device=dev))
    return PoseGraph(
        poses=poses, node_valid=flag(node_valid, N), edges_from=edges_from,
        edges_to=torch.as_tensor(edges_to, **i64),
        edges_meas=torch.as_tensor(edges_meas, **f32),
        edges_info=torch.as_tensor(edges_info, **f32).contiguous(),
        edge_valid=flag(edge_valid, E), root=int(root),
        priors_idx=torch.as_tensor(priors_idx, **i64),
        priors_meas=torch.as_tensor(priors_meas, **f32),
        priors_info=torch.as_tensor(priors_info, **f32),
        prior_valid=flag(prior_valid, P))


# ----------------------------------------------------------------- residuals


def _edge_residual(pose_i, pose_j, meas):
    """r = log(meas^-1 * (pose_i^-1 * pose_j)) -> (...,6)."""
    return T.se3_log(T.compose(T.inverse(meas), T.relative(pose_i, pose_j)))


def _series_or(small, series, direct):
    return torch.where(small, series, direct)


def _se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) [rho, phi] -> (...,6,6): d log(exp(xi) exp(d)) / d d at d = 0,
    the inverse right Jacobian of SE(3), which is the inverse left Jacobian
    at -xi: [[A, -A Q A], [0, A]] with A = J_l^-1(-phi) and Barfoot's
    Q(-rho, -phi). Q's coefficients switch to their series below
    theta = 0.5, where float32 cancellation would spoil the closed forms."""
    rho, phi = -xi[..., :3], -xi[..., 3:]
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-12))
    small = theta2 < 0.25
    t4 = theta2 * theta2
    t6 = t4 * theta2
    s, c = torch.sin(theta), torch.cos(theta)
    c1 = _series_or(small, 1.0 / 6 - theta2 / 120 + t4 / 5040 - t6 / 362880,
                    (theta - s) / (theta2 * theta))
    c2 = _series_or(small, 1.0 / 24 - theta2 / 720 + t4 / 40320 - t6 / 3628800,
                    (theta2 + 2 * c - 2) / (2 * t4))
    c3 = _series_or(small, 1.0 / 120 - theta2 / 2520 + t4 / 120960 - t6 / 9979200,
                    (2 * theta - 3 * s + theta * c) / (2 * t4 * theta))
    P, Rh = T.so3_hat(phi), T.so3_hat(rho)
    PR, RP, PP = P @ Rh, Rh @ P, P @ P
    PRP = PR @ P
    Q = (0.5 * Rh + c1[..., None, None] * (PR + RP + PRP)
         + c2[..., None, None] * (PP @ Rh + RP @ P - 3 * PRP)
         + c3[..., None, None] * (PRP @ P + PP @ RP))
    A = T._so3_left_jacobian_inv(phi)
    top = torch.cat([A, -A @ Q @ A], dim=-1)
    bottom = torch.cat([torch.zeros_like(A), A], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _adjoint(Tm: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,6,6) adjoint for [rho, phi] twists: [[R, t^ R], [0, R]]."""
    R = T.rotation(Tm)
    top = torch.cat([R, T.so3_hat(T.translation(Tm)) @ R], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def _edge_residual_jac(pose_i, pose_j, meas):
    """Residuals (E,6) and their Jacobians (E,6,6) with respect to right
    perturbations of pose_i and pose_j, in closed form: with
    r = log(meas^-1 pose_i^-1 pose_j), dr/dxi_j = Jr^-1(r) and
    dr/dxi_i = -Jr^-1(r) Ad(pose_j^-1 pose_i) (the derivatives the JAX
    twin takes by forward-mode autodiff)."""
    r = _edge_residual(pose_i, pose_j, meas)
    Jj = _se3_right_jacobian_inv(r)
    return r, -Jj @ _adjoint(T.relative(pose_j, pose_i)), Jj


def _prior_residual_jac(pose, meas):
    """Unary residuals log(meas^-1 * T) (P,6) and Jacobians Jr^-1(r) (P,6,6)
    with respect to a right perturbation of T."""
    r = T.se3_log(T.compose(T.inverse(meas), pose))
    return r, _se3_right_jacobian_inv(r)


def _prior_blocks(g: PoseGraph, poses):
    """(P,6) residuals, (P,6,6) H blocks, (P,6) b contributions."""
    rp, Jp = _prior_residual_jac(poses[g.priors_idx], g.priors_meas)
    info = g.priors_info * g.prior_valid[:, None, None]
    JtI = torch.einsum("pki,pkl->pil", Jp, info)
    return rp, torch.einsum("pil,plj->pij", JtI, Jp), torch.einsum("pil,pl->pi", JtI, rp)


def _prior_cost(g: PoseGraph, poses):
    rp, _ = _prior_residual_jac(poses[g.priors_idx], g.priors_meas)
    info = g.priors_info * g.prior_valid[:, None, None]
    return torch.einsum("pi,pij,pj->p", rp, info, rp).sum()


def graph_residuals(g: PoseGraph) -> torch.Tensor:
    """(E,6) residuals, invalid edges zeroed."""
    r = _edge_residual(g.poses[g.edges_from], g.poses[g.edges_to], g.edges_meas)
    return torch.where(g.edge_valid[:, None], r, torch.zeros_like(r))


def graph_chi2(g: PoseGraph) -> torch.Tensor:
    r = graph_residuals(g)
    chi2 = torch.einsum("ei,eij,ej->e", r, g.edges_info, r).sum()
    if g.priors_idx.shape[0] > 0:
        chi2 = chi2 + _prior_cost(g, g.poses)
    return chi2


def edge_errors(g: PoseGraph):
    """Per-edge error ratios of graph::computeMaxGraphErrors: linear = max
    |component difference| of the optimized relative pose and the link
    over the link's translational stddev; angular = geodesic angle over
    the rotational stddev (variance = 1 / min information diagonal).
    Returns (lin_ratio (E,), ang_ratio (E,))."""
    rel = T.relative(g.poses[g.edges_from], g.poses[g.edges_to])
    lin_err = (T.translation(rel) - T.translation(g.edges_meas)).abs().max(dim=-1).values
    dR = T.rotation_angle(T.compose(T.inverse(g.edges_meas), rel))
    diag = g.edges_info.diagonal(dim1=-2, dim2=-1)
    trans_std = torch.sqrt(1.0 / torch.clamp_min(diag[:, :3].min(dim=-1).values, 1e-12))
    rot_std = torch.sqrt(1.0 / torch.clamp_min(diag[:, 3:].min(dim=-1).values, 1e-12))
    zero = torch.zeros_like(lin_err)
    return (torch.where(g.edge_valid, lin_err / trans_std, zero),
            torch.where(g.edge_valid, dR / rot_std, zero))


def solve_diagnostics(g: PoseGraph):
    """Post-solve edge diagnostics, kept on the device for one fetch: the
    worst edge-error ratio (linear or angular, ``edge_errors``), the worst
    angular ratio, the worst absolute linear and angular edge deviations
    and their edge indices."""
    lin_ratio, ang_ratio = edge_errors(g)
    rel = T.relative(g.poses[g.edges_from], g.poses[g.edges_to])
    dlin = (T.translation(rel) - T.translation(g.edges_meas)).abs().max(dim=-1).values
    dang = T.rotation_angle(T.compose(T.inverse(g.edges_meas), rel))
    neg = torch.full_like(dlin, -1.0)
    k_lin = torch.argmax(torch.where(g.edge_valid, dlin, neg))
    k_ang = torch.argmax(torch.where(g.edge_valid, dang, neg))
    max_err = torch.maximum(lin_ratio.max(), ang_ratio.max())
    return (max_err, ang_ratio.max(), dlin[k_lin], dang[k_ang], k_lin, k_ang)


# ------------------------------------------------------------------- solvers

# DCS switch target: the 99% chi-square(6) quantile, so calibrated closures
# stay fully on while an outlier is still crushed (see the JAX twin).
DCS_PHI_DEFAULT = 16.81


def _chi2_edges(r, info):
    return torch.einsum("ei,eij,ej->e", r, info, r)


def _robust_cost(g: PoseGraph, poses, robust: bool, huber_delta: float,
                 switch_mask, phi):
    """The robust objective the LM step is accepted on: chi2, its Huber rho,
    or with DCS switchable edges the saturating min(chi2, phi)."""
    r = graph_residuals(g._replace(poses=poses))
    chi2_e = _chi2_edges(r, g.edges_info)
    if robust:
        m = torch.sqrt(torch.clamp_min(chi2_e, 1e-12))
        rho = torch.where(m <= huber_delta, chi2_e, huber_delta * (2.0 * m - huber_delta))
    else:
        rho = chi2_e
    if switch_mask is not None:
        rho = torch.where(switch_mask, torch.minimum(rho, phi), rho)
    cost = (rho * g.edge_valid).sum()
    if g.priors_idx.shape[0] > 0:
        cost = cost + _prior_cost(g, poses)
    return cost


def _dcs_phi0(g: PoseGraph, switch_mask, dcs_phi: float):
    """Anneal start: twice the median chi2 of the unsatisfied switchable
    edges at the initial poses, at least ``dcs_phi``."""
    chi0_e = _chi2_edges(graph_residuals(g), g.edges_info)
    sw = switch_mask & g.edge_valid & (chi0_e > dcs_phi)
    n_sw = sw.sum()
    vals = torch.sort(torch.where(sw, chi0_e, float("inf"))).values
    med = vals[torch.clamp((n_sw - 1) // 2, 0, vals.shape[0] - 1)]
    med = torch.where(n_sw > 0, med, torch.full_like(med, dcs_phi))
    return torch.clamp_min(2.0 * med, dcs_phi)


def _dcs_phi_schedule(phi0, dcs_phi: float, n_acc, iters: int):
    """Geometric anneal phi0 -> dcs_phi driven by the accepted-step count."""
    frac = torch.clamp(1.0 - n_acc / max(iters - 1, 1), 0.0, 1.0)
    return dcs_phi * (phi0 / dcs_phi) ** frac


def _huber_weights(r, info, delta: float):
    """Per-edge robust reweighting factor (Huber on the Mahalanobis norm)."""
    m = torch.sqrt(torch.clamp_min(_chi2_edges(r, info), 1e-12))
    return torch.where(m <= delta, torch.ones_like(m), delta / m)


def _dcs_weights(r, info, switch_mask, phi):
    """Dynamic covariance scaling on switchable edges: s = min(1,
    2 phi / (phi + chi2)), applied as s^2; other edges keep weight 1."""
    chi2 = _chi2_edges(r, info)
    s = torch.clamp_max(2.0 * phi / (phi + chi2), 1.0)
    return torch.where(switch_mask, torch.clamp_min(s * s, 1e-6), torch.ones_like(s))


def _assemble_dense(g: PoseGraph, r, Ji, Jj, w, damping: float):
    """Dense (6N,6N) normal matrix and (6N,) gradient, with the root node
    and invalid nodes clamped by a 1e8 diagonal."""
    N = g.poses.shape[0]
    dev = g.poses.device
    info_w = g.edges_info * (w * g.edge_valid)[:, None, None]
    JiT_O = torch.einsum("eki,ekl->eil", Ji, info_w)
    JjT_O = torch.einsum("eki,ekl->eil", Jj, info_w)
    six = torch.arange(6, device=dev)
    rows_f = (g.edges_from[:, None] * 6 + six)[:, :, None]    # (E,6,1)
    rows_t = (g.edges_to[:, None] * 6 + six)[:, :, None]
    H = torch.zeros((6 * N, 6 * N), dtype=torch.float32, device=dev)
    Hij = torch.einsum("eil,elj->eij", JiT_O, Jj)
    for (ri, ci), blk in (((rows_f, rows_f), torch.einsum("eil,elj->eij", JiT_O, Ji)),
                          ((rows_f, rows_t), Hij),
                          ((rows_t, rows_f), Hij.transpose(-1, -2)),
                          ((rows_t, rows_t), torch.einsum("eil,elj->eij", JjT_O, Jj))):
        H.index_put_((ri.expand(blk.shape), ci.transpose(1, 2).expand(blk.shape)),
                     blk, accumulate=True)
    b = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    b.index_add_(0, g.edges_from, torch.einsum("eil,el->ei", JiT_O, r))
    b.index_add_(0, g.edges_to, torch.einsum("eil,el->ei", JjT_O, r))
    if g.priors_idx.shape[0] > 0:   # unary GPS / gravity / pose priors
        _, Hp, bp = _prior_blocks(g, g.poses)
        rows_p = (g.priors_idx[:, None] * 6 + six)[:, :, None]
        H.index_put_((rows_p.expand(Hp.shape), rows_p.transpose(1, 2).expand(Hp.shape)),
                     Hp, accumulate=True)
        b.index_add_(0, g.priors_idx, bp)
    root_mask = torch.nn.functional.one_hot(torch.tensor(g.root, device=dev), N).float()
    fix = root_mask + (~g.node_valid).float()
    diag_boost = fix.repeat_interleave(6) * 1e8 + damping
    return H + torch.diag(diag_boost + 1e-8), b.reshape(6 * N)


def optimize_dense(g: PoseGraph, iters: int = 20, damping: float = 1e-4,
                   robust: bool = False, huber_delta: float = 1.0,
                   switch_mask: Optional[torch.Tensor] = None,
                   dcs_phi: float = DCS_PHI_DEFAULT) -> Tuple[PoseGraph, torch.Tensor]:
    """Levenberg-Marquardt with a dense Cholesky, for graphs up to a few
    hundred nodes: scale-invariant damping (lambda diag H); a step that
    raises the robust objective or is not finite (a float32 Cholesky
    breakdown) is rejected and lambda raised. Returns (graph, chi2)."""
    N = g.poses.shape[0]
    dev = g.poses.device
    poses = g.poses
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    n_acc = torch.zeros((), dtype=torch.float32, device=dev)
    phi0 = _dcs_phi0(g, switch_mask, dcs_phi) if switch_mask is not None else None
    cur = None
    for _ in range(iters):
        r, Ji, Jj = _edge_residual_jac(poses[g.edges_from], poses[g.edges_to], g.edges_meas)
        w = (_huber_weights(r, g.edges_info, huber_delta) if robust
             else torch.ones(r.shape[0], device=dev))
        phi_k = None
        if switch_mask is not None:
            phi_k = _dcs_phi_schedule(phi0, dcs_phi, n_acc, iters)
            w = w * _dcs_weights(r, g.edges_info, switch_mask, phi_k)
        H, b = _assemble_dense(g._replace(poses=poses), r, Ji, Jj, w, 0.0)
        dH = torch.clamp_min(H.diagonal(), 1e-8)
        L, info = torch.linalg.cholesky_ex(H + torch.diag(lam * dH))
        dx = -torch.cholesky_solve(b[:, None], L)[:, 0]
        # a failed factorization gives no step (JAX's cho_factor gives NaN)
        dx = torch.where(info == 0, dx, float("nan")).reshape(N, 6)
        dx = torch.where(g.node_valid[:, None], dx, torch.zeros_like(dx))
        # trust region: cap the step to keep log/exp well-behaved
        nrm = torch.linalg.norm(dx, dim=-1, keepdim=True)
        dx = dx * torch.clamp_max(1.0 / torch.clamp_min(nrm, 1e-9), 1.0)
        cand = T.retract(poses, dx)
        if cur is None or switch_mask is not None:
            # without DCS the objective does not change between iterations,
            # so the accepted pose's cost carries over (the same numbers)
            cur = _robust_cost(g, poses, robust, huber_delta, switch_mask, phi_k)
        new = _robust_cost(g, cand, robust, huber_delta, switch_mask, phi_k)
        ok = torch.isfinite(new) & (new <= cur)
        poses = torch.where(ok, cand, poses)
        cur = torch.where(ok, new, cur)
        lam = torch.where(ok, torch.clamp_min(lam / 3.0, 1e-9), torch.clamp_max(lam * 10.0, 1e8))
        n_acc = n_acc + ok.float()
    out = g._replace(poses=poses)
    return out, graph_chi2(out)


def optimize(g: PoseGraph, iters: int = 20, robust: bool = False,
             dense_threshold: int = 400, switch_mask: Optional[torch.Tensor] = None,
             dcs_phi: float = DCS_PHI_DEFAULT):
    """Solver dispatch of Optimizer::create: the dense LM up to
    ``dense_threshold`` nodes."""
    N = g.poses.shape[0]
    if N > dense_threshold:
        raise NotImplementedError(
            f"a {N}-node graph needs optimize_pcg (the matrix-free PCG solver), "
            f"which is not ported yet; the dense solver takes up to {dense_threshold}")
    return optimize_dense(g, iters=iters, robust=robust, switch_mask=switch_mask,
                          dcs_phi=dcs_phi)

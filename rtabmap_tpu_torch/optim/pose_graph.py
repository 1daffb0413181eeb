"""SE(3) pose-graph optimization: Levenberg-Marquardt, dense or matrix-free.

Port of ``rtabmap_tpu/optim/pose_graph.py`` (the reference's g2o/GTSAM
``Optimizer`` role: SE(3) edges with 6x6 information, Huber and DCS robust
kernels, pose priors, a fixed root). Residuals and their per-edge
Jacobians come in closed form (the inverse right Jacobian of SE(3) and the
adjoint; the JAX twin differentiates the same residual by forward-mode
autodiff). Up to ``dense_threshold`` nodes the normal system is assembled
dense and solved by a float32 Cholesky (``optimize_dense``); past it,
``optimize_pcg`` solves each step by a fixed number of Jacobi-
preconditioned conjugate-gradient iterations whose H x product is a gather
and a scatter over the edges. Both accept an LM step on the robust
objective and drive the DCS anneal by the count of accepted steps; the
iterations are Python loops of device operations with no host sync
(acceptance is a ``torch.where``). On the card the fixed-length CG loop of
a shape bucket is captured once in a CUDA graph and replayed: one replay
a step where the eager loop launches about 19 operations an iteration;
so are the dense LM's iterations of a call, one replay where the eager
loop launches some hundreds of small operations an iteration.
``solve_diagnostics`` gives the engine's post-solve edge statistics and
``optimize_poses_dict`` the tool-side solve over id -> pose dicts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
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
    # gather, not a 0-dim tensor index (that reads the index on the host)
    med = vals.gather(0, torch.clamp((n_sw - 1) // 2, 0, vals.shape[0] - 1).reshape(1))[0]
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
        # scatter-add the 6x6 blocks through flat indices (no sort, no sync)
        H.view(-1).index_add_(0, (ri * (6 * N) + ci.transpose(1, 2)).reshape(-1),
                              blk.reshape(-1))
    b = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    b.index_add_(0, g.edges_from, torch.einsum("eil,el->ei", JiT_O, r))
    b.index_add_(0, g.edges_to, torch.einsum("eil,el->ei", JjT_O, r))
    if g.priors_idx.shape[0] > 0:   # unary GPS / gravity / pose priors
        _, Hp, bp = _prior_blocks(g, g.poses)
        rows_p = (g.priors_idx[:, None] * 6 + six)[:, :, None]
        H.view(-1).index_add_(0, (rows_p * (6 * N) + rows_p.transpose(1, 2)).reshape(-1),
                              Hp.reshape(-1))
        b.index_add_(0, g.priors_idx, bp)
    root_mask = (torch.arange(N, device=dev) == g.root).float()
    fix = root_mask + (~g.node_valid).float()
    diag_boost = fix.repeat_interleave(6) * 1e8 + damping
    return H + torch.diag(diag_boost + 1e-8), b.reshape(6 * N)


def optimize_dense(g: PoseGraph, iters: int = 20, damping: float = 1e-4,
                   robust: bool = False, huber_delta: float = 1.0,
                   switch_mask: Optional[torch.Tensor] = None,
                   dcs_phi: float = DCS_PHI_DEFAULT,
                   graphs: bool = True) -> Tuple[PoseGraph, torch.Tensor]:
    """Levenberg-Marquardt with a dense Cholesky, for graphs up to a few
    hundred nodes: scale-invariant damping (lambda diag H); a step that
    raises the robust objective or is not finite (a float32 Cholesky
    breakdown) is rejected and lambda raised. On a CUDA device the
    ``iters`` iterations of a shape bucket run as one captured graph
    (``graphs=False``: eagerly, the loop the graph is held to). Returns
    (graph, chi2)."""
    opts = (iters, damping, robust, huber_delta, dcs_phi)
    if g.poses.device.type != "cuda" or not graphs:
        return _optimize_dense(g, switch_mask, *opts)
    key = ((g.poses.device, g.root, switch_mask is None) + opts
           + tuple(tuple(t.shape) for t in _graph_tensors(g)))
    cap = _DENSE_GRAPHS.get(key)
    if cap is None:
        cap = _DENSE_GRAPHS[key] = _CapturedDense(g, switch_mask, opts)
    return cap(g, switch_mask)


def _graph_tensors(g: PoseGraph):
    return tuple(v for v in g if isinstance(v, torch.Tensor))


class _CapturedDense:
    """``_optimize_dense`` of one shape bucket and option set captured in a
    CUDA graph: the graph's tensors (and the switch mask) are copied into
    static buffers, the graph is replayed, the poses and chi2 are read
    from its static outputs."""

    def __init__(self, g: PoseGraph, switch_mask, opts):
        self.g = g._replace(**{k: v.clone() for k, v in g._asdict().items()
                               if isinstance(v, torch.Tensor)})
        self.switch = None if switch_mask is None else switch_mask.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up (handles, workspaces) outside the capture
            _optimize_dense(self.g, self.switch, 1, *opts[1:])
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, self.chi2 = _optimize_dense(self.g, self.switch, *opts)

    def __call__(self, g: PoseGraph, switch_mask):
        for dst, src in zip(_graph_tensors(self.g), _graph_tensors(g)):
            dst.copy_(src)
        if switch_mask is not None:
            self.switch.copy_(switch_mask)
        self.graph.replay()
        return g._replace(poses=self.out.poses.clone()), self.chi2.clone()


# Captured dense LM graphs by (device, root, options, shapes): like _CG_GRAPHS,
# a few shape buckets a process.
_DENSE_GRAPHS: Dict[tuple, _CapturedDense] = {}


def _optimize_dense(g: PoseGraph, switch_mask, iters: int, damping: float, robust: bool,
                    huber_delta: float, dcs_phi: float) -> Tuple[PoseGraph, torch.Tensor]:
    N = g.poses.shape[0]
    dev = g.poses.device
    poses = g.poses
    lam = torch.full((), damping, dtype=torch.float32, device=dev)
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


def _sum_plan(idx: torch.Tensor, valid: torch.Tensor, N: int) -> torch.Tensor:
    """(N, D) positions in ``idx`` of each node's valid terms, in order,
    padded with ``len(idx)`` (a zero row for ``_plan_sum``); D is the
    largest count rounded up to a power of two. Summing a node's terms
    along its row fixes their order on any device, where ``index_add_``
    on the card adds them by atomics in whatever order they land, and so
    makes the PCG step reproducible (its captured CUDA graph and the eager
    loop give the same poses). One host sync (D)."""
    n, dev = idx.shape[0], idx.device
    pos = torch.nonzero(valid)[:, 0]
    node = idx[pos]
    order = torch.argsort(node, stable=True)
    pos, node = pos[order], node[order]
    counts = torch.bincount(node, minlength=N)
    D = 1 << max(int(counts.max()) - 1, 0).bit_length() if node.numel() else 1
    rank = torch.arange(node.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[node]
    plan = torch.full((N, D), n, dtype=torch.int64, device=dev)
    plan[node, rank] = pos
    return plan


def _plan_sum(plan: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """(N, ...) sums of ``terms`` (n, ...) along the rows of ``_sum_plan``."""
    return torch.cat([terms, terms.new_zeros((1,) + terms.shape[1:])])[plan].sum(1)


def _hx_product(Jc, info_w, idx2, plan2, node_blocks, x):
    """Matrix-free H @ x (x (N,6)) by a gather and a scatter over the edges:
    y_e = Ji x_from + Jj x_to (``Jc`` (E,6,12) is [Ji Jj], ``idx2`` (2E,)
    each edge's from and to indices in turn), then Jc^T Omega y_e summed
    back to both nodes along ``plan2`` (``_sum_plan`` of ``idx2`` over the
    valid edges), plus the per-node blocks (damping, gauge clamp,
    priors). As in the twin, Omega multiplies y after the two Jacobian
    products have cancelled: an edge block Jc^T Omega Jc formed first would
    cancel at the scale of Omega (1e8 on some odometry edges) in float32."""
    E = Jc.shape[0]
    y = info_w @ (Jc @ x[idx2].reshape(E, 12, 1))
    out = (node_blocks @ x.unsqueeze(-1)).squeeze(-1)
    return out + _plan_sum(plan2, (Jc.transpose(-1, -2) @ y).reshape(2 * E, 6))


def _cg(Jc, info_w, idx2, plan2, node_blocks, minv, b, cg_iters: int):
    """``cg_iters`` Jacobi-preconditioned conjugate-gradient iterations on
    H dx = b from dx = 0, with no early exit (the twin's fixed-length
    ``lax.scan``) and no host sync."""
    x = torch.zeros_like(b)
    rr = b.clone()
    z = minv * b
    p = z.clone()
    rz = (b * z).sum()
    for _ in range(cg_iters):
        Ap = _hx_product(Jc, info_w, idx2, plan2, node_blocks, p)
        alpha = rz / torch.clamp_min((p * Ap).sum(), 1e-12)
        x.addcmul_(alpha, p)
        rr.addcmul_(alpha, Ap, value=-1.0)
        torch.mul(minv, rr, out=z)
        rz_new = (rr * z).sum()
        p.mul_(rz_new / torch.clamp_min(rz, 1e-12)).add_(z)
        rz = rz_new
    return x


class _CapturedCG:
    """``_cg`` of one shape bucket captured in a CUDA graph: inputs are
    copied into static buffers, the graph is replayed, the result is read
    from its static output."""

    def __init__(self, args, cg_iters: int):
        self.inputs = [a.clone() for a in args]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up outside the capture
            _cg(*self.inputs, cg_iters=1)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.output = _cg(*self.inputs, cg_iters=cg_iters)

    def __call__(self, args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return self.output.clone()


# Captured CG graphs by (device, shapes, iterations): a cache of compiled
# work, like the kernels' loaded libraries; a few shape buckets a process.
_CG_GRAPHS: Dict[tuple, _CapturedCG] = {}


def _solve_cg(args, cg_iters: int, graphs: bool = True):
    """``_cg`` on ``args``; on a CUDA device through the bucket's captured
    graph (``graphs=False`` runs the eager loop, which the graph is held
    to)."""
    if args[0].device.type != "cuda" or not graphs:
        return _cg(*args, cg_iters=cg_iters)
    key = (args[0].device, cg_iters) + tuple(tuple(a.shape) for a in args)
    cap = _CG_GRAPHS.get(key)
    if cap is None:
        cap = _CG_GRAPHS[key] = _CapturedCG(args, cg_iters)
    return cap(args)


def _pcg_step(g: PoseGraph, poses, lam, robust: bool, huber_delta: float,
              switch_mask, phi, damping: float, cg_iters: int, graphs: bool, plans):
    """One damped Gauss-Newton step solved by PCG; returns the candidate
    poses (the caller accepts or rejects them). ``plans``: the
    ``_sum_plan`` of the edges' node indices and of the priors'."""
    N, dev = poses.shape[0], poses.device
    r, Ji, Jj = _edge_residual_jac(poses[g.edges_from], poses[g.edges_to], g.edges_meas)
    w = (_huber_weights(r, g.edges_info, huber_delta) if robust
         else torch.ones(r.shape[0], device=dev))
    if switch_mask is not None:
        w = w * _dcs_weights(r, g.edges_info, switch_mask, phi)
    info_w = g.edges_info * (w * g.edge_valid)[:, None, None]
    E = r.shape[0]
    idx2 = torch.stack([g.edges_from, g.edges_to], dim=1).reshape(-1)
    plan2, plan_p = plans
    Jc = torch.cat([Ji, Jj], dim=-1)
    b = _plan_sum(plan2, (Jc.transpose(-1, -2) @ (info_w @ r.unsqueeze(-1))).reshape(2 * E, 6))
    # Jacobi preconditioner: diag(H), each edge's diag(Jc^T Omega Jc)
    diag = _plan_sum(plan2, (Jc * (info_w @ Jc)).sum(-2).reshape(2 * E, 6))
    node_blocks = torch.zeros((N, 6, 6), dtype=torch.float32, device=dev)
    if g.priors_idx.shape[0] > 0:
        _, Hp, bp = _prior_blocks(g, poses)
        b = b + _plan_sum(plan_p, bp)
        diag = diag + _plan_sum(plan_p, Hp.diagonal(dim1=-2, dim2=-1))
        node_blocks = node_blocks + _plan_sum(plan_p, Hp)
    # gauge and invalid-node clamps, and LM damping lambda diag(H)
    root = torch.nn.functional.one_hot(torch.tensor(g.root, device=dev), N).float()
    fix = (root + (~g.node_valid).float()) * 1e8 + damping
    damp6 = fix[:, None] + lam * torch.clamp_min(diag, 1e-8)
    node_blocks = node_blocks + torch.diag_embed(damp6)
    minv = 1.0 / (diag + damp6 + 1e-8)
    dx = _solve_cg((Jc, info_w, idx2, plan2, node_blocks, minv, -b), cg_iters, graphs)
    dx = torch.where(g.node_valid[:, None], dx, torch.zeros_like(dx))
    nrm = torch.linalg.norm(dx, dim=-1, keepdim=True)
    dx = dx * torch.clamp_max(1.0 / torch.clamp_min(nrm, 1e-9), 1.0)
    return T.retract(poses, dx)


def optimize_pcg(g: PoseGraph, iters: int = 15, cg_iters: int = 60, damping: float = 1e-4,
                 robust: bool = False, huber_delta: float = 1.0,
                 switch_mask: Optional[torch.Tensor] = None,
                 dcs_phi: float = DCS_PHI_DEFAULT,
                 graphs: bool = True) -> Tuple[PoseGraph, torch.Tensor]:
    """Levenberg-Marquardt whose steps are solved by ``cg_iters`` iterations
    of matrix-free Jacobi-preconditioned CG, for graphs too large for the
    dense Cholesky. A step that raises the robust objective or is not
    finite is rejected and lambda raised. On a CUDA device the CG loop
    runs as a captured graph (``graphs=False``: eagerly). Every sum over
    the edges runs in a fixed order (``_sum_plan``), so the result does
    not depend on the order of atomics. Returns (graph, chi2)."""
    dev = g.poses.device
    N = g.poses.shape[0]
    plans = (_sum_plan(torch.stack([g.edges_from, g.edges_to], dim=1).reshape(-1),
                       g.edge_valid.repeat_interleave(2), N),
             _sum_plan(g.priors_idx, g.prior_valid, N))
    poses = g.poses
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    n_acc = torch.zeros((), dtype=torch.float32, device=dev)
    phi0 = _dcs_phi0(g, switch_mask, dcs_phi) if switch_mask is not None else None
    cur = None
    for _ in range(iters):
        phi_k = (_dcs_phi_schedule(phi0, dcs_phi, n_acc, iters)
                 if switch_mask is not None else None)
        cand = _pcg_step(g, poses, lam, robust, huber_delta, switch_mask, phi_k, damping,
                         cg_iters, graphs, plans)
        if cur is None or switch_mask is not None:
            # without DCS the objective does not change between iterations
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
    ``dense_threshold`` nodes, PCG past it. Jacobi-PCG moves information
    about one graph hop a CG iteration, so the inner solve gets about N
    iterations (at least 60, at most 1024), as in the twin."""
    N = g.poses.shape[0]
    if N <= dense_threshold:
        return optimize_dense(g, iters=iters, robust=robust, switch_mask=switch_mask,
                              dcs_phi=dcs_phi)
    return optimize_pcg(g, iters=iters, cg_iters=int(min(max(60, N), 1024)), robust=robust,
                        switch_mask=switch_mask, dcs_phi=dcs_phi)


def optimize_poses_dict(poses, links, root_id=None, iters: int = 12, robust: bool = False,
                        device=None) -> Dict[int, np.ndarray]:
    """Offline solve over ``{id: (3,4) pose}`` and links (``from_id``,
    ``to_id``, ``type``, ``transform``, ``information``) on ``device``
    (None = the CUDA card): the tool-side entry of the reference's
    ``Optimizer::optimize`` after ``getConnectedGraph``. A landmark link
    (negative ``to_id``) places its landmark at ``from * t`` when absent;
    only the connected component of ``root_id`` (default: the smallest
    id) is solved, everything else is returned unchanged. Nodes and edges
    are padded to powers of two."""
    from rtabmap_tpu_torch.memory.memory import LINK_LANDMARK, LINK_POSE_PRIOR

    poses = dict(poses)
    edges, seen = [], set()
    for lk in links:
        if lk.type == LINK_POSE_PRIOR or lk.transform is None:
            continue
        key = (min(lk.from_id, lk.to_id), max(lk.from_id, lk.to_id), lk.type)
        if key in seen or lk.from_id == lk.to_id:
            continue
        seen.add(key)
        if lk.type == LINK_LANDMARK and lk.to_id not in poses and lk.from_id in poses:
            poses[lk.to_id] = T.np_compose(np.asarray(poses[lk.from_id], np.float32),
                                           np.asarray(lk.transform, np.float32))
        if lk.from_id in poses and lk.to_id in poses:
            edges.append(lk)
    if not poses:
        return {}
    adj: Dict[int, list] = {}
    for lk in edges:
        adj.setdefault(lk.from_id, []).append(lk.to_id)
        adj.setdefault(lk.to_id, []).append(lk.from_id)
    root = root_id if root_id in poses else min(poses)
    comp, stack = {root}, [root]
    while stack:
        for nb in adj.get(stack.pop(), []):
            if nb not in comp:
                comp.add(nb)
                stack.append(nb)
    ids = sorted(i for i in comp if i >= 0) + sorted(i for i in comp if i < 0)
    if len(ids) < 2:
        return poses
    index = {i: k for k, i in enumerate(ids)}
    edges = [lk for lk in edges if lk.from_id in comp and lk.to_id in comp]
    if not edges:
        return poses
    N, E = len(ids), len(edges)
    Np, Ep = 1 << max(N - 1, 1).bit_length(), 1 << max(E - 1, 1).bit_length()
    P = np.tile(np.eye(3, 4, dtype=np.float32), (Np, 1, 1))
    for i in ids:
        P[index[i]] = np.asarray(poses[i], np.float32)
    ef, et = np.zeros((Ep,), np.int64), np.zeros((Ep,), np.int64)
    meas = np.tile(np.eye(3, 4, dtype=np.float32), (Ep, 1, 1))
    info = np.tile(np.eye(6, dtype=np.float32)[None], (Ep, 1, 1))
    for k, lk in enumerate(edges):
        ef[k], et[k] = index[lk.from_id], index[lk.to_id]
        meas[k] = np.asarray(lk.transform, np.float32)
        if lk.information is not None:
            info[k] = np.asarray(lk.information, np.float32)
    g = make_graph(P, ef, et, meas, info, node_valid=np.arange(Np) < N,
                   edge_valid=np.arange(Ep) < E, root=index[root], device=device)
    out, _chi2 = optimize(g, iters=iters, robust=robust)
    solved = out.poses.cpu().numpy()
    result = dict(poses)
    for i in ids:
        result[i] = solved[index[i]]
    return result

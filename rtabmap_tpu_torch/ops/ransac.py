"""Batched fixed-iteration RANSAC motion solvers (3D-3D and PnP).

Port of ``rtabmap_tpu/ops/ransac.py``: the weighted Kabsch fit with its
rank-2 completion, ``ransac_rigid`` and the PnP-RANSAC of the visual
odometry and registration (``_dlt_pnp`` hypotheses by inverse iteration
on the 12x12 normal equations, Kabsch hypotheses from the query frame's
own 3D, the guess joined to the pool, two rounds of masked Gauss-Newton
refinement, the quartile covariance). Every hypothesis is solved in one
batched pass with no data-dependent control flow; the solvers are
batched over any leading axes, so several registrations are one call.

Randomness: the hypotheses' sample indices come from ``_sample_indices``
on an explicit CPU ``torch.Generator`` (the same samples on any device),
or are passed in (``indices=``), so a parity test can inject the JAX
twin's own draws. ``fit_plane_ransac``
comes with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops.linalg import (
    chol_solve_unrolled, det3, eigvec_min_sym3, polar_so3,
)


class RansacResult(NamedTuple):
    transform: torch.Tensor    # (...,3,4) best model (dst <- src)
    inliers: torch.Tensor      # (...,K) bool
    num_inliers: torch.Tensor  # (...) int32
    success: torch.Tensor      # (...) bool
    covariance: torch.Tensor   # (...,6,6) pose covariance estimate


def rigid_from_correspondences(src: torch.Tensor, dst: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares rigid fit dst ~ R src + t -> (...,3,4).

    src/dst (...,K,3), w (...,K) nonnegative. Umeyama/Kabsch with the SVD
    replaced by the Newton polar iteration. A planar set makes the
    cross-covariance rank 2, where the polar iteration diverges; the
    missing direction is completed with the null-space pair u3 v3^T,
    signed so that det(R) = +1 (the Kabsch solution U diag(1,1,s) V^T).
    """
    wn = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    mu_s = (src * wn[..., None]).sum(-2)
    mu_d = (dst * wn[..., None]).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    H = torch.einsum("...ki,...kj,...k->...ij", sc, dc, wn)
    M = H.transpose(-1, -2)
    MtM = torch.einsum("...ki,...kj->...ij", M, M)
    MMt = torch.einsum("...ik,...jk->...ij", M, M)
    lam_v, v3 = eigvec_min_sym3(MtM)   # src-side null direction
    _, u3 = eigvec_min_sym3(MMt)       # dst-side null direction
    tr = MtM.diagonal(dim1=-2, dim2=-1).sum(-1)
    deficient = lam_v < 1e-6 * tr + 1e-20
    gamma = torch.where(deficient, 0.5 * torch.sqrt(torch.clamp_min(tr, 1e-30)),
                        torch.zeros_like(tr))
    outer = u3[..., :, None] * v3[..., None, :]
    sign = torch.sign(torch.linalg.det(M + gamma[..., None, None] * outer))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    R = polar_so3(M + (sign * gamma)[..., None, None] * outer)
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return T.from_rt(R, t)


def _augment_minimal_3pt(s3: torch.Tensor, d3: torch.Tensor):
    """Append a virtual 4th correspondence, the plane normal of the
    centred 3-point sample scaled to its spread, to (...,3,3) minimal
    samples, so the Kabsch cross-covariance of a planar triple pins the
    out-of-plane direction."""

    def aug(p):
        c = p.mean(dim=-2, keepdim=True)
        e = p - c
        n = torch.linalg.cross(e[..., 1, :] - e[..., 0, :], e[..., 2, :] - e[..., 0, :],
                               dim=-1)
        scale = torch.linalg.norm(e, dim=(-2, -1))[..., None]
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12) * scale
        return torch.cat([p, (c[..., 0, :] + n)[..., None, :]], dim=-2)

    return aug(s3), aug(d3)


def _sample_indices(generator: Optional[torch.Generator], valid: torch.Tensor,
                    n_hyp: int, n_pts: int) -> torch.Tensor:
    """(..., n_hyp, n_pts) int64 indices drawn from the valid slots of
    ``valid`` (...,K); repeats are possible (a degenerate sample gives a
    zero-inlier model). Raw 30-bit integers map onto the compacted table
    of valid slots (valid slots first, in index order), as in the JAX twin;
    only the draws differ (``torch.randint``). The raw integers come from a
    CPU ``generator`` whatever the device, so one seed gives the same
    samples on the CPU and on the card; they reach the card by a
    non-blocking copy from pinned memory (no host sync)."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    nv = torch.clamp_min(valid.sum(-1, keepdim=True), 1)          # (...,1)
    lead = valid.shape[:-1]
    r = torch.randint(0, 1 << 30, (*lead, n_hyp * n_pts), generator=generator)
    if valid.device.type == "cuda":
        r = r.pin_memory().to(valid.device, non_blocking=True)
    idx = torch.gather(order, -1, r % nv)
    return idx.reshape(*lead, n_hyp, n_pts)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (...,K,C) rows at idx (...,H,S) -> (...,H,S,C)."""
    lead, (H, S), Cn = idx.shape[:-2], idx.shape[-2:], x.shape[-1]
    flat = idx.reshape(*lead, H * S, 1).expand(*lead, H * S, Cn)
    return torch.gather(x, -2, flat).reshape(*lead, H, S, Cn)


def _pick(models: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """models (...,H,3,4) at best (...) -> (...,3,4)."""
    ix = best[..., None, None, None].expand(*best.shape, 1, 3, 4)
    return torch.gather(models, -3, ix)[..., 0, :, :]


# ------------------------------------------------------------------ 3D -> 3D


def ransac_rigid(src, dst, valid, generator: Optional[torch.Generator] = None,
                 iters: int = 256, threshold: float = 0.1, min_inliers: int = 6,
                 refine_rounds: int = 3, indices: Optional[torch.Tensor] = None
                 ) -> RansacResult:
    """3D-3D RANSAC: T with dst ~ T(src), distances in metres. ``indices``
    (..., iters, 3) replaces the drawn samples."""
    idx = indices if indices is not None else _sample_indices(generator, valid, iters, 3)
    idx = idx.long()
    s3, d3 = _augment_minimal_3pt(_gather_rows(src, idx), _gather_rows(dst, idx))
    models = rigid_from_correspondences(s3, d3, torch.ones(s3.shape[:-1], dtype=src.dtype,
                                                           device=src.device))
    err = torch.linalg.norm(T.apply(models, src[..., None, :, :]) - dst[..., None, :, :],
                            dim=-1)
    counts = ((err < threshold) & valid[..., None, :]).sum(-1)
    model = _pick(models, torch.argmax(counts, dim=-1))
    for _ in range(refine_rounds):   # IRLS on the best model's inliers
        err = torch.linalg.norm(T.apply(model, src) - dst, dim=-1)
        w = (valid & (err < threshold)).to(src.dtype)
        model = rigid_from_correspondences(src, dst, w)
    err = torch.linalg.norm(T.apply(model, src) - dst, dim=-1)
    inliers = valid & (err < threshold)
    n = inliers.sum(-1)
    var = (torch.where(inliers, err * err, torch.zeros_like(err)).sum(-1)
           / torch.clamp_min(n - 3, 1))
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    cov = eye6 * torch.clamp_min(var, 1e-8)[..., None, None]
    return RansacResult(model, inliers, n.to(torch.int32), n >= min_inliers, cov)


# ------------------------------------------------------------------ PnP


def _dlt_pnp(pts3d: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """DLT from 6+ points: P (3x4) from 3D points (...,N,3) and normalized
    image coordinates (...,N,2) -> world->camera (...,3,4).

    The smallest eigenvector of A^T A by four inverse-iteration solves of
    the regularized 12x12 system; P = s [R|t] up to a signed scale, which
    the signed cube root of det(sR) = s^3 recovers; then the rotation is
    projected onto SO(3)."""
    ones = torch.ones((*pts3d.shape[:-1], 1), dtype=pts3d.dtype, device=pts3d.device)
    X = torch.cat([pts3d, ones], dim=-1)
    z = torch.zeros_like(X)
    u, v = xn[..., 0:1], xn[..., 1:2]
    A = torch.cat([torch.cat([X, z, -u * X], dim=-1),
                   torch.cat([z, X, -v * X], dim=-1)], dim=-2)     # (...,2N,12)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(12, dtype=AtA.dtype, device=AtA.device)
    Areg = AtA + (1e-9 * tr + 1e-12)[..., None, None] * eye
    p = torch.ones((*AtA.shape[:-2], 12), dtype=AtA.dtype, device=AtA.device)
    for _ in range(4):
        p = chol_solve_unrolled(Areg, p)
        p = p / torch.clamp_min(torch.linalg.norm(p, dim=-1, keepdim=True), 1e-30)
    P = p.reshape(*p.shape[:-1], 3, 4)
    R = P[..., :3]
    d = det3(R)
    scale = torch.sign(d) * d.abs() ** (1.0 / 3.0)
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
    Rn = polar_so3(R / scale[..., None, None])
    return T.from_rt(Rn, P[..., 3] / scale[..., None])


def _reproj_residuals(Tcw: torch.Tensor, pts3d: torch.Tensor, xn: torch.Tensor):
    """Normalized-plane reprojection residuals (...,N,2) and depths (...,N)
    for the world->camera pose Tcw."""
    pc = (torch.einsum("...ij,...nj->...ni", T.rotation(Tcw), pts3d)
          + T.translation(Tcw)[..., None, :])
    z = torch.where(pc[..., 2].abs() > 1e-6, pc[..., 2], torch.full_like(pc[..., 2], 1e-6))
    return pc[..., :2] / z[..., None] - xn, pc[..., 2]


def pnp_gn(pts3d, xn, w, Tcw0, iters: int = 8, damping: float = 1e-4):
    """Weighted Gauss-Newton PnP refinement on the normalized plane, the
    Jacobian taken for a left-multiplied twist on Tcw. pts3d (...,N,3),
    xn (...,N,2), w (...,N), Tcw0 (...,3,4). Returns (Tcw, residuals,
    depths)."""
    Tcw = Tcw0
    eye6 = torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for _ in range(iters):
        res, depth = _reproj_residuals(Tcw, pts3d, xn)
        pc = (torch.einsum("...ij,...nj->...ni", T.rotation(Tcw), pts3d)
              + T.translation(Tcw)[..., None, :])
        x, y = pc[..., 0], pc[..., 1]
        z = torch.where(pc[..., 2].abs() > 1e-6, pc[..., 2], torch.full_like(x, 1e-6))
        iz = 1.0 / z
        iz2 = iz * iz
        zeros = torch.zeros_like(x)
        Ju = torch.stack([iz, zeros, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz], -1)
        Jv = torch.stack([zeros, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz], -1)
        J = torch.stack([Ju, Jv], dim=-2)                             # (...,N,2,6)
        ww = w * (depth > 0)
        JtJ = torch.einsum("...nri,...nrj,...n->...ij", J, J, ww)
        Jtr = torch.einsum("...nri,...nr,...n->...i", J, res, ww)
        dx = -chol_solve_unrolled(JtJ + damping * eye6, Jtr)
        Tcw = T.retract_left(Tcw, dx)
    res, depth = _reproj_residuals(Tcw, pts3d, xn)
    return Tcw, res, depth


def pnp_sample_indices(generator: Optional[torch.Generator], valid: torch.Tensor,
                       iters: int, with_query_3d: bool) -> Tuple[torch.Tensor, ...]:
    """The samples ``ransac_pnp`` draws: (6-point DLT samples,) or, with
    the query frame's 3D, (DLT samples for iters//2 hypotheses, 3-point
    Kabsch samples for the rest)."""
    if not with_query_3d:
        return (_sample_indices(generator, valid, iters, 6),)
    n_dlt = iters // 2
    return (_sample_indices(generator, valid, n_dlt, 6),
            _sample_indices(generator, valid, iters - n_dlt, 3))


def ransac_pnp(pts3d, uv, valid, cam: C.CameraModel,
               generator: Optional[torch.Generator] = None, iters: int = 256,
               reproj_px: float = 4.0, min_inliers: int = 20,
               guess: Optional[torch.Tensor] = None,
               pts3d_query: Optional[torch.Tensor] = None, refine_iters: int = 8,
               indices: Optional[Tuple[torch.Tensor, ...]] = None,
               graphs: bool = True) -> RansacResult:
    """PnP-RANSAC: the camera pose from world points pts3d (...,K,3) and
    pixel observations uv (...,K,2) with flags valid (...,K). Returns the
    camera-in-world motion ``T_wc``.

    Hypotheses: batched 6-point DLT; with ``pts3d_query`` (the query
    frame's own 3D, (...,K,3), zero where missing) half are 3-point Kabsch
    fits instead, well-posed on planar scenes. ``guess`` (...,3,4
    camera-in-world) joins the pool. Inliers by reprojection error; the
    winner is refined by two rounds of hard-inlier Gauss-Newton. The
    covariance follows the reference's robust 3D-disagreement convention
    (2.1981 x the lower quartile of the inliers' squared 3D distances and
    angles) with query 3D, else the RMS reprojection error. ``indices``
    replaces the drawn samples (see ``pnp_sample_indices``).

    On the card an unbatched call runs as one captured CUDA graph of its
    shapes and options (``graphs=False``: eagerly, the ops the graph
    replays): the solve is a few thousand small launches and no host
    read."""
    if indices is None:
        indices = pnp_sample_indices(generator, valid, iters, pts3d_query is not None)
    opts = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(reproj_px),
            int(min_inliers), int(refine_iters))
    args = (pts3d, uv, valid, guess, pts3d_query) + tuple(indices)
    if pts3d.device.type != "cuda" or not graphs or pts3d.dim() != 2:
        return _ransac_pnp(*args, opts=opts)
    key = (pts3d.device, opts) + tuple(None if t is None else (tuple(t.shape), t.dtype)
                                       for t in args)
    cap = _PNP_GRAPHS.get(key)
    if cap is None:
        cap = _PNP_GRAPHS[key] = _CapturedPnP(args, opts)
    return cap(args)


class _CapturedPnP:
    """``_ransac_pnp`` of one shape and option set captured in a CUDA
    graph: the inputs are copied into static buffers, the graph replayed,
    the result cloned from its static outputs."""

    def __init__(self, args, opts):
        self.args = tuple(None if t is None else t.clone() for t in args)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up (handles, workspaces) outside the capture
            _ransac_pnp(*self.args, opts=opts)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _ransac_pnp(*self.args, opts=opts)

    def __call__(self, args) -> RansacResult:
        for dst, src in zip(self.args, args):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return RansacResult(*(t.clone() for t in self.out))


# Captured PnP-RANSAC graphs by (device, options, shapes): a few a process
# (the odometry's, the registrations' with and without a guess).
_PNP_GRAPHS: dict = {}


def _ransac_pnp(pts3d, uv, valid, guess, pts3d_query, *indices, opts) -> RansacResult:
    fx, fy, cx, cy, reproj_px, min_inliers, refine_iters = opts
    thr_n = reproj_px / fx
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    idx = indices[0].long()
    models = _dlt_pnp(_gather_rows(pts3d, idx), _gather_rows(xn, idx))
    if pts3d_query is not None:
        idx3 = indices[1].long()
        s3, d3 = _augment_minimal_3pt(_gather_rows(pts3d, idx3), _gather_rows(pts3d_query, idx3))
        w3 = torch.ones(s3.shape[:-1], dtype=pts3d.dtype, device=pts3d.device)
        models = torch.cat([models, rigid_from_correspondences(s3, d3, w3)], dim=-3)
    if guess is not None:
        models = torch.cat([models, T.inverse(guess)[..., None, :, :]], dim=-3)
    res, depth = _reproj_residuals(models, pts3d[..., None, :, :], xn[..., None, :, :])
    err = torch.linalg.norm(res, dim=-1)
    counts = ((err < thr_n) & valid[..., None, :] & (depth > 0)).sum(-1)
    Tcw = _pick(models, torch.argmax(counts, dim=-1))
    for _ in range(2):
        res, depth = _reproj_residuals(Tcw, pts3d, xn)
        err = torch.linalg.norm(res, dim=-1)
        w = (valid & (err < thr_n) & (depth > 0)).to(pts3d.dtype)
        Tcw, _, _ = pnp_gn(pts3d, xn, w, Tcw, iters=refine_iters)
    res, depth = _reproj_residuals(Tcw, pts3d, xn)
    err = torch.linalg.norm(res, dim=-1)
    inliers = valid & (err < thr_n) & (depth > 0)
    n = inliers.sum(-1)
    T_wc = T.inverse(Tcw)
    inf = torch.full((), float("inf"), dtype=pts3d.dtype, device=pts3d.device)
    if pts3d_query is not None:
        has_q = (pts3d_query != 0.0).any(-1)
        mapped = T.apply(T_wc, pts3d_query)
        cov_valid = inliers & has_q
        d2 = ((pts3d - mapped) ** 2).sum(-1)
        cosang = (pts3d * mapped).sum(-1) / torch.clamp_min(
            torch.linalg.norm(pts3d, dim=-1) * torch.linalg.norm(mapped, dim=-1), 1e-9)
        ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        q_idx = (torch.clamp_min(cov_valid.sum(-1), 1) // 4)[..., None]

        def quartile_var(x):
            xs = torch.sort(torch.where(cov_valid, x, inf), dim=-1).values
            v = 2.1981 * torch.gather(xs, -1, q_idx)[..., 0]
            return torch.where(torch.isfinite(v), torch.clamp_min(v, 1e-8),
                               torch.ones_like(v))

        lin_var, ang_var = quartile_var(d2), quartile_var(ang)
    else:
        px_err2 = torch.where(inliers[..., None], res * res,
                              torch.zeros_like(res)).sum((-2, -1)) * (fx * fx)
        rms = torch.sqrt(px_err2 / torch.clamp_min(n, 1))
        lin_var = ang_var = torch.clamp_min(torch.sqrt(rms), 1e-8)
    diag = torch.stack([lin_var] * 3 + [ang_var] * 3, dim=-1)
    return RansacResult(T_wc, inliers, n.to(torch.int32), n >= min_inliers,
                        torch.diag_embed(diag))

"""Epipolar geometry: fundamental, essential and homography RANSAC, and the
loop-hypothesis verification.

Port of ``rtabmap_tpu/ops/epipolar.py`` (the reference's
``EpipolarGeometry::check``): normalized eight-point F solves (the null
vector by inverse iteration on the 9x9 normal equations, rank 2 by
removing the smallest singular triplet), Sampson-distance inlier tests,
the calibrated E and H fan-outs with their decompositions and cheirality
votes. Every RANSAC solves all its hypotheses in one batched pass. The
sample indices come from ``ops/ransac._sample_indices`` on a CPU
``torch.Generator`` or are passed in (``indices=``), so a parity test can
inject the JAX twin's draws.

SVD singular vectors are defined up to sign, and LAPACK builds may pick
other signs than the JAX twin's: E and H come out up to sign (Sampson and
transfer errors are even in them), and ``decompose_essential`` may give
its two rotations in the other order; the cheirality votes pick the same
physical pose.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rtabmap_tpu_torch.ops.linalg import chol_solve_unrolled, eigvec_min_sym3
from rtabmap_tpu_torch.ops.ransac import _sample_indices


def _rows(x1, x2):
    """The eight-point design rows (...,N,9) of x2^T F x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1)


def _eight_point(x1, x2):
    """Normalized 8-point F estimate. x1, x2 (...,8,2). Returns (...,3,3)."""

    def normalize(x):
        mu = x.mean(dim=-2, keepdim=True)
        s = 2.0 ** 0.5 / torch.clamp_min(
            torch.linalg.norm(x - mu, dim=-1).mean(dim=-1, keepdim=True), 1e-9)
        Tm = torch.zeros((*x.shape[:-2], 3, 3), dtype=x.dtype, device=x.device)
        Tm[..., 0, 0] = s[..., 0]
        Tm[..., 1, 1] = s[..., 0]
        Tm[..., 2, 2] = 1.0
        Tm[..., 0, 2] = -s[..., 0] * mu[..., 0, 0]
        Tm[..., 1, 2] = -s[..., 0] * mu[..., 0, 1]
        return (x - mu) * s[..., None], Tm

    x1n, T1 = normalize(x1)
    x2n, T2 = normalize(x2)
    A = _rows(x1n, x2n)
    # the null vector by inverse iteration on AtA (shifted so the float32
    # Cholesky stays well conditioned; the null vector still dominates)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)
    Areg = AtA + (1e-5 * tr + 1e-12)[..., None, None] * torch.eye(9, dtype=A.dtype,
                                                                   device=A.device)
    f = torch.ones((*AtA.shape[:-2], 9), dtype=A.dtype, device=A.device)
    for _ in range(6):
        f = chol_solve_unrolled(Areg, f)
        f = f / torch.clamp_min(torch.linalg.norm(f, dim=-1, keepdim=True), 1e-30)
    F = f.reshape(*A.shape[:-2], 3, 3)
    # rank 2: subtract the smallest singular triplet s3 u3 v3^T, u3/v3 the
    # null directions of F F^T and F^T F
    _, v3 = eigvec_min_sym3(torch.einsum("...ki,...kj->...ij", F, F))
    _, u3 = eigvec_min_sym3(torch.einsum("...ik,...jk->...ij", F, F))
    s3 = torch.einsum("...i,...ij,...j->...", u3, F, v3)
    F = F - s3[..., None, None] * u3[..., :, None] * v3[..., None, :]
    return T2.transpose(-1, -2) @ F @ T1


def _homog(x):
    return torch.cat([x, torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)],
                     dim=-1)


def sampson_distance(F, x1, x2):
    """Sampson epipolar distance. F (...,3,3), x1/x2 (...,N,2)."""
    p1, p2 = _homog(x1), _homog(x2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, p2)
    num = torch.einsum("...ni,...ni->...n", p2, Fx1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def _draw(valid, generator, iters: int, n_pts: int, indices):
    idx = indices if indices is not None else _sample_indices(generator, valid, iters, n_pts)
    return idx.long().to(valid.device)


def ransac_fundamental(x1, x2, valid, generator: Optional[torch.Generator] = None,
                       iters: int = 128, threshold_px: float = 3.0,
                       indices: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched F-RANSAC. Returns (F (3,3), inlier mask (N,)). ``indices``
    (iters, 8) replaces the drawn samples."""
    idx = _draw(valid, generator, iters, 8, indices)
    Fs = _eight_point(x1[idx], x2[idx])
    d = sampson_distance(Fs, x1[None], x2[None])
    inl = (d < threshold_px ** 2) & valid[None]
    F = Fs[torch.argmax(inl.sum(-1))]
    inliers = valid & (sampson_distance(F, x1, x2) < threshold_px ** 2)
    return F, inliers


# --------------------------------------------------------- calibrated (mono)


def _project_essential(E):
    U, S, Vt = torch.linalg.svd(E)
    Sm = torch.zeros_like(S)
    Sm[..., :2] = 1.0
    return (U * Sm[..., None, :]) @ Vt


def essential_from_pairs(x1n, x2n):
    """8-point essential estimate from normalized coordinates (...,8,2): the
    F solve projected onto the essential manifold (singular values
    (1,1,0)), batched over leading dims."""
    A = _rows(x1n, x2n)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    return _project_essential(Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))


def essential_refit(x1n, x2n, w):
    """Weighted least-squares E over all correspondences (w (N,) weights,
    typically the inlier mask)."""
    A = w[..., None] * _rows(x1n, x2n)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    return _project_essential(Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_essential(E):
    """E -> (R_a, R_b, t) candidate factors (t unit norm; 4 combos +-t)."""
    U, _, Vt = torch.linalg.svd(E)
    dU = torch.sign(torch.linalg.det(U))
    dV = torch.sign(torch.linalg.det(Vt))
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * dU[..., None, None]], dim=-1)
    Vt = torch.cat([Vt[..., :2, :], Vt[..., 2:, :] * dV[..., None, None]], dim=-2)
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def triangulate_midpoint(R, t, x1n, x2n):
    """Midpoint triangulation, cam1 at the origin, X2 = R X1 + t. x1n/x2n
    (N,2) normalized coordinates. Returns (X (N,3) in cam1, z1, z2)."""
    d1 = _homog(x1n)
    d2c1 = torch.einsum("ji,nj->ni", R, _homog(x2n))
    c2 = -torch.einsum("ji,j->i", R, t)
    a = (d1 * d1).sum(-1)
    b = (d1 * d2c1).sum(-1)
    c = (d2c1 * d2c1).sum(-1)
    e1 = (c2[None] * d1).sum(-1)
    e2 = (c2[None] * d2c1).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    s = (c * e1 - b * e2) / det
    r = (b * e1 - a * e2) / det
    X = 0.5 * (s[..., None] * d1 + c2[None] + r[..., None] * d2c1)
    z2 = (torch.einsum("ij,nj->ni", R, X) + t[None])[..., 2]
    return X, X[..., 2], z2


def _cheirality(R, t, x1n, x2n, inliers):
    _, z1, z2 = triangulate_midpoint(R, t, x1n, x2n)
    return inliers & (z1 > 1e-3) & (z2 > 1e-3)


def ransac_essential(x1n, x2n, valid, generator: Optional[torch.Generator] = None,
                     iters: int = 192, threshold: float = 5e-3,
                     indices: Optional[torch.Tensor] = None):
    """Calibrated two-view relative pose from normalized correspondences:
    batched 8-point E hypotheses -> Sampson gate -> two consensus refits ->
    decompose -> cheirality vote over the four (R, +-t) candidates.

    Returns (T21 (3,4) with unit-norm translation, inliers (N,), pts3d
    (N,3) midpoint triangulation in cam1, pts_ok (N,))."""
    idx = _draw(valid, generator, iters, 8, indices)
    Es = essential_from_pairs(x1n[idx], x2n[idx])
    d = sampson_distance(Es, x1n[None], x2n[None])
    inl = (d < threshold ** 2) & valid[None]
    E = Es[torch.argmax(inl.sum(-1))]
    inliers = valid & (sampson_distance(E, x1n, x2n) < threshold ** 2)
    for _ in range(2):
        E = essential_refit(x1n, x2n, inliers.to(x1n.dtype))
        inliers = valid & (sampson_distance(E, x1n, x2n) < threshold ** 2)
    Ra, Rb, t = decompose_essential(E)
    Rs = torch.stack([Ra, Ra, Rb, Rb])
    ts = torch.stack([t, -t, t, -t])
    counts = torch.stack([_cheirality(Rs[k], ts[k], x1n, x2n, inliers).sum()
                          for k in range(4)])
    winner = torch.argmax(counts)
    R_best, t_best = Rs[winner], ts[winner]
    X, z1, z2 = triangulate_midpoint(R_best, t_best, x1n, x2n)
    pts_ok = inliers & (z1 > 1e-3) & (z2 > 1e-3)
    return torch.cat([R_best, t_best[:, None]], dim=1), inliers, X, pts_ok


# ------------------------------------------------------------- homography


def homography_from_pairs(x1, x2, w=None):
    """DLT homography from (...,M,2) pairs (M >= 4), optional per-row
    weights (...,M) for consensus refits. Returns (...,3,3), x2 ~ H x1."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                         # (...,2M,9)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    return Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def transfer_error(H, x1, x2):
    """Symmetric transfer error ||x2 - H x1||^2 + ||x1 - H^-1 x2||^2."""

    def fwd(Hm, a, b):
        q = torch.einsum("...ij,...nj->...ni", Hm, _homog(a))
        w = q[..., 2:]
        qn = q[..., :2] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
        return ((qn - b) ** 2).sum(-1)

    return fwd(H, x1, x2) + fwd(torch.linalg.inv_ex(H)[0], x2, x1)


def ransac_homography(x1, x2, valid, generator: Optional[torch.Generator] = None,
                      iters: int = 192, threshold: float = 5e-3,
                      indices: Optional[torch.Tensor] = None):
    """Batched 4-point H-RANSAC + 2 consensus refits. Returns (H (3,3),
    inliers (N,))."""
    idx = _draw(valid, generator, iters, 4, indices)
    Hs = homography_from_pairs(x1[idx], x2[idx])
    d = transfer_error(Hs, x1[None], x2[None])
    thr2 = 2.0 * threshold ** 2  # symmetric error budget
    inl = (d < thr2) & valid[None]
    H = Hs[torch.argmax(inl.sum(-1))]
    inliers = valid & (transfer_error(H, x1, x2) < thr2)
    for _ in range(2):
        H = homography_from_pairs(x1, x2, inliers.to(x1.dtype))
        inliers = valid & (transfer_error(H, x1, x2) < thr2)
    return H, inliers


def decompose_homography(H, x1, x2, inliers):
    """Faugeras SVD decomposition of a calibrated homography into the four
    (R, t, n) motion candidates, the projective sign fixed so that inlier
    points satisfy x2^T H x1 > 0. Returns (Rs (4,3,3), ts (4,3), ns (4,3));
    t is scaled by 1/d (the plane distance)."""
    s = torch.einsum("ni,ij,nj->n", _homog(x2), H, _homog(x1))
    vote = torch.where(inliers, torch.sign(s), torch.zeros_like(s)).sum()
    H = H * torch.where(vote >= 0, 1.0, -1.0).to(H.dtype)
    sv = torch.linalg.svdvals(H)
    H = H / torch.clamp_min(sv[1], 1e-12)
    _, S2, Vt = torch.linalg.svd(H.T @ H)
    V = Vt.T
    V = V * torch.sign(torch.linalg.det(V))
    s1, s3 = S2[0], S2[2]
    a = torch.sqrt(torch.clamp_min(1.0 - s3, 0.0))
    b = torch.sqrt(torch.clamp_min(s1 - 1.0, 0.0))
    nrm = torch.clamp_min(torch.sqrt(torch.clamp_min(s1 - s3, 0.0)), 1e-12)
    v1, v2, v3 = V[:, 0], V[:, 1], V[:, 2]
    cross = lambda p, q: torch.linalg.cross(p, q, dim=-1)  # noqa: E731

    def sol(u):
        U = torch.stack([v2, u, cross(v2, u)], dim=1)
        W = torch.stack([H @ v2, H @ u, cross(H @ v2, H @ u)], dim=1)
        R = W @ U.T
        n = cross(v2, u)
        return R, (H - R) @ n, n

    R1, t1, n1 = sol((a * v1 + b * v3) / nrm)
    R2, t2, n2 = sol((a * v1 - b * v3) / nrm)
    return (torch.stack([R1, R1, R2, R2]), torch.stack([t1, -t1, t2, -t2]),
            torch.stack([n1, -n1, n2, -n2]))


def pose_from_homography(H, x1n, x2n, inliers):
    """Pick the physical (R, t) among the four homography factors by
    cheirality vote (+ a plane-in-front tie-break), triangulating structure.
    Returns (T21 (3,4), pts3d (N,3) in cam1, pts_ok (N,))."""
    Rs, ts, ns = decompose_homography(H, x1n, x2n, inliers)
    counts = torch.stack([
        _cheirality(Rs[k], ts[k], x1n, x2n, inliers).sum().to(H.dtype)
        + torch.where(ns[k][2] > 0, 0.5, 0.0).to(H.dtype) for k in range(4)])
    winner = torch.argmax(counts)
    R, t = Rs[winner], ts[winner]
    X, z1, z2 = triangulate_midpoint(R, t, x1n, x2n)
    ok = inliers & (z1 > 1e-3) & (z2 > 1e-3)
    return torch.cat([R, t[:, None]], dim=1), X, ok


def check_hypothesis(uv_a, uv_b, valid, generator: Optional[torch.Generator] = None,
                     min_pairs: int = 8, threshold_px: float = 3.0,
                     inlier_ratio: float = 0.5, indices: Optional[torch.Tensor] = None):
    """Loop-hypothesis verification (reference: EpipolarGeometry::check):
    accept when enough correspondences satisfy one epipolar geometry.
    Returns device tensors (ok, F, inliers)."""
    n = valid.sum()
    F, inl = ransac_fundamental(uv_a, uv_b, valid, generator, threshold_px=threshold_px,
                                indices=indices)
    ok = (n >= min_pairs) & (inl.sum() >= torch.clamp_min(inlier_ratio * n, min_pairs))
    return ok, F, inl

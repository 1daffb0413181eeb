"""Small closed-form linear algebra: 3x3 inverse, polar factor, unrolled
Cholesky solve, analytic symmetric 3x3 eigenpairs.

Port of ``rtabmap_tpu/ops/linalg.py``. The analytic forms are kept, with
their exact fallbacks (the ``1e-20`` clamps, the ``p1 < 1e-20`` diagonal
case, the ``+z`` eigenvector of an isotropic matrix): ``estimate_normals``
and the weighted Kabsch fit depend on them. All functions are batched over
leading dims and take tensors on any device.
"""
from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of 3x3 matrices by the rule of Sarrus, the closed form
    ``jnp.linalg.det`` takes for 3x3 (no LU factorization, no kernel
    launches beyond elementwise ones), summed in its order."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([Cc, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def polar_so3(M: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Nearest-orthogonal factor by Newton polar iteration
    X <- (X + X^-T)/2, sign-flipped to a proper rotation if det < 0."""
    X = M / (torch.sqrt((M * M).sum(dim=(-2, -1), keepdim=True)) + 1e-12)
    for _ in range(iters):
        X = 0.5 * (X + inv3(X).transpose(-1, -2))
    s = torch.sign(det3(X))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return X * s[..., None, None]


def chol_solve_unrolled(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """SPD solve A x = b for a small static n by Cholesky and substitution.

    Written column by column (right-looking): each entry sees the same
    products, subtracted in the same order, as the JAX twin's fully
    unrolled form, in about 3n vector operations instead of n^3/3 scalar
    ones (each a kernel launch on the card)."""
    n = A.shape[-1]
    if jitter:
        A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    S = A                     # S[..., i, j]: A[i, j] minus the products so far
    cols, diag = [], []
    for j in range(n):
        djj = torch.sqrt(torch.clamp_min(S[..., j, j], 1e-20))
        col = S[..., j + 1:, j] / djj[..., None]          # L[j+1:, j]
        diag.append(djj)
        cols.append(col)
        if j + 1 < n:
            S = S - torch.nn.functional.pad(
                col[..., :, None] * col[..., None, :], (j + 1, 0, j + 1, 0))
    # L[i][k] for i > k is cols[k][i - k - 1]
    y = []
    r = b
    for i in range(n):
        yi = r[..., i] / diag[i]
        y.append(yi)
        if i + 1 < n:
            r = r - torch.nn.functional.pad(cols[i] * yi[..., None], (i + 1, 0))
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - cols[i][..., k - i - 1] * x[k]
        x[i] = s / diag[i]
    return torch.stack(x, dim=-1)


def eig_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric 3x3 matrices, ascending, by the analytic
    trigonometric formula; an already diagonal matrix (p1 < 1e-20) gives
    its sorted diagonal."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Bm = (A - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(det3(Bm) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    e2 = 3.0 * q - e1 - e3
    diag = torch.sort(torch.stack([a00, a11, a22], -1), dim=-1).values
    analytic = torch.stack([e3, e2, e1], -1)
    return torch.where((p1 < 1e-20)[..., None], diag, analytic)


def eigvec_min_sym3(A: torch.Tensor):
    """(smallest eigenvalue, its unit eigenvector) of symmetric 3x3
    matrices: the largest cross product of two rows of (A - lambda I),
    ``+z`` for an isotropic matrix."""
    lam = eig_sym3(A)[..., 0]
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n = torch.stack([(c01 * c01).sum(-1), (c02 * c02).sum(-1), (c12 * c12).sum(-1)], -1)
    best = torch.argmax(n, dim=-1)
    v = torch.where((best == 0)[..., None], c01, torch.where((best == 1)[..., None], c02, c12))
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)   # +z, built on the device (capturable in a CUDA graph)
    fallback[..., 2] = 1.0
    v = torch.where(nrm > 1e-15, v / torch.clamp_min(nrm, 1e-30), fallback)
    return lam, v

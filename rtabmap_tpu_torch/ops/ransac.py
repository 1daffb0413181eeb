"""Weighted rigid fit from 3-D correspondences (the Kabsch step of ICP).

Port of ``rigid_from_correspondences`` from ``rtabmap_tpu/ops/ransac.py``,
with its rank-2 completion for planar point sets. The RANSAC solvers of
that module belong to the RGB-D slice and are not ported yet.
"""
from __future__ import annotations

import torch

from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops.linalg import eigvec_min_sym3, polar_so3


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

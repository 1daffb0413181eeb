"""ICP registration, point-to-point and point-to-plane, on fixed slabs.

Port of ``rtabmap_tpu/ops/icp.py``. Correspondences are exact nearest
neighbours from the Hopper kernel K2 (``ops/cuda/nn3d.py``; its plain
version on CPU tensors), rejected beyond ``max_corr_dist``. K2 searches
for the valid source points only (a masked one reads +inf, which no
threshold accepts, so the results are the JAX twin's ``src_valid & ...``
masks bit for bit), and one ``icp()`` call compacts its destination and
source mask once for all its searches. The rigid step
is the weighted Kabsch fit (point-to-point) or the 6x6 Gauss-Newton solve
(point-to-plane). The iterations are a Python loop of device operations
with no host sync inside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import cloud as CL
from rtabmap_tpu_torch.ops import linalg as L3
from rtabmap_tpu_torch.ops.cuda.nn3d import nn3d, nn3d_prepare, nn3d_search
from rtabmap_tpu_torch.ops.ransac import rigid_from_correspondences


class IcpResult(NamedTuple):
    transform: torch.Tensor            # (3,4) dst <- src
    valid: torch.Tensor                # () bool
    correspondence_ratio: torch.Tensor
    fitness_rmse: torch.Tensor
    iterations: int = 0


def _nn_blocked(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor,
                src_valid: Optional[torch.Tensor] = None):
    """For each src point: (dist2, index) of the nearest valid dst point,
    by K2 at every Q and N (the TPU kernel's Q%512/N%2048 gate is gone);
    (+inf, 0) where ``src_valid`` is false."""
    return nn3d(src.contiguous(), dst.contiguous(), dst_valid.contiguous(),
                None if src_valid is None else src_valid.contiguous())


def icp(src: torch.Tensor, src_valid: torch.Tensor, dst: torch.Tensor,
        dst_valid: torch.Tensor, guess: Optional[torch.Tensor] = None,
        dst_normals: Optional[torch.Tensor] = None, iters: int = 30,
        max_corr_dist: float = 0.5, point_to_plane: bool = False,
        min_corr_ratio: float = 0.2) -> IcpResult:
    """Align src onto dst: returns T with dst ~ T(src). ``iters`` searches
    and steps, then one more search for the statistics."""
    if guess is None:
        guess = T.identity(dtype=src.dtype, device=src.device)
    max_d2 = max_corr_dist ** 2
    eye6 = 1e-6 * torch.eye(6, dtype=src.dtype, device=src.device)
    Tcur = guess
    plan = nn3d_prepare(dst.contiguous(), dst_valid.contiguous(), src_valid.contiguous())
    for _ in range(iters):
        moved = T.apply(Tcur[None], src[None])[0]
        d2, idx = nn3d_search(moved.contiguous(), plan)
        w = (d2 < max_d2).to(src.dtype)             # masked sources read +inf
        q = dst[idx.long()]
        if point_to_plane:
            nrm = dst_normals[idx.long()]
            r = ((moved - q) * nrm).sum(-1)              # signed plane distance
            # J_i = [n^T, (p x n)^T] for xi = [rho, phi] (left perturbation)
            J = torch.cat([nrm, torch.linalg.cross(moved, nrm, dim=-1)], dim=-1)
            H = torch.einsum("ni,nj,n->ij", J, J, w) + eye6
            b = torch.einsum("ni,n,n->i", J, r, w)
            xi = -L3.chol_solve_unrolled(H, b)
            Tcur = T.compose(T.se3_exp(xi), Tcur)
        else:
            Tcur = T.compose(rigid_from_correspondences(moved, q, w), Tcur)
    moved = T.apply(Tcur[None], src[None])[0]
    d2, _ = nn3d_search(moved.contiguous(), plan)
    inl = d2 < max_d2
    ratio = inl.sum() / torch.clamp_min(src_valid.sum(), 1)
    # the clamp of the JAX twin, whose expanded-form distances can dip below 0
    rmse = torch.sqrt(torch.where(inl, torch.clamp_min(d2, 0.0), 0.0).sum()
                      / torch.clamp_min(inl.sum(), 1))
    return IcpResult(transform=Tcur, valid=ratio >= min_corr_ratio,
                     correspondence_ratio=ratio, fitness_rmse=rmse, iterations=iters)


def register_scans(scan_src: torch.Tensor, valid_src: torch.Tensor,
                   scan_dst: torch.Tensor, valid_dst: torch.Tensor,
                   guess: Optional[torch.Tensor] = None, voxel: float = 0.05,
                   point_to_plane: bool = True, max_corr_dist: float = 0.5,
                   iters: int = 30):
    """RegistrationIcp pipeline: voxel-filter both scans, dst normals (for
    point-to-plane), ICP, covariance from the residual. Returns
    (IcpResult, covariance (6,6)); asks K2 for ``iters + 1`` searches."""
    if voxel > 0:
        valid_src = CL.voxel_filter(scan_src, valid_src, voxel)
        valid_dst = CL.voxel_filter(scan_dst, valid_dst, voxel)
    normals = None
    if point_to_plane:
        normals, _ = CL.estimate_normals(scan_dst, valid_dst, k=8)
    res = icp(scan_src, valid_src, scan_dst, valid_dst, guess=guess,
              dst_normals=normals, iters=iters, max_corr_dist=max_corr_dist,
              point_to_plane=point_to_plane)
    var = torch.clamp_min(res.fitness_rmse ** 2, 1e-6)
    cov = torch.diag(torch.cat([var.expand(3), (var * 0.1).expand(3)]))
    return res, cov

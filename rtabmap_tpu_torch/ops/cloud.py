"""Point-cloud utilities: depth -> cloud, voxel filter, normals, range and
box filters, random subsampling.

Port of ``rtabmap_tpu/ops/cloud.py``. Clouds are fixed-capacity (N,3)
slabs with validity masks: filters return an updated mask and never move
or merge points.
"""
from __future__ import annotations

from typing import Optional

import torch

from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import linalg as L3

# rows of the dense distance matrix taken at once by estimate_normals
_NORMALS_PAIRS = 1 << 25


def cloud_from_depth(depth: torch.Tensor, cam: C.CameraModel, decimation: int = 1,
                     min_depth: float = 0.0, max_depth: float = 0.0):
    """Dense organized cloud (H*W, 3) in the camera frame + validity mask."""
    d = depth[::decimation, ::decimation]
    H, W = d.shape
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=d.device),
                            torch.arange(W, dtype=torch.float32, device=d.device),
                            indexing="ij")
    scale = float(decimation)
    uv = torch.stack([uu * scale, vv * scale], dim=-1).reshape(-1, 2)
    z = d.reshape(-1)
    pts = C.backproject(uv, z, cam)
    ok = z > (min_depth if min_depth > 0 else 1e-6)
    if max_depth > 0:
        ok = ok & (z < max_depth)
    return pts, ok


def transform_cloud(T_ab: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return T.apply(T_ab[None], pts[None])[0]


def voxel_filter(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                 hash_size: int = 1 << 16) -> torch.Tensor:
    """Keep the first valid point landing in each voxel hash cell; returns
    the updated mask. The JAX twin hashes with wrapping int32 products;
    here they are int64, whose low bits, the only ones the mask keeps,
    are the same."""
    q = torch.floor(pts / voxel).to(torch.int32).to(torch.int64)
    h = ((q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)) & (hash_size - 1)
    n = pts.shape[0]
    order = torch.arange(n, dtype=torch.int64, device=pts.device)
    owner = torch.full((hash_size,), n, dtype=torch.int64, device=pts.device)
    owner = owner.scatter_reduce(0, h, torch.where(valid, order, n), "amin")
    return valid & (owner[h] == order)


def _knn_blocked(pts: torch.Tensor, valid: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """(N,k) indices of each row's k nearest rows by direct squared
    differences, a block of rows at a time so that the N x N matrix never
    sits whole in memory; with ``valid``, pairs with an invalid end read
    +inf."""
    n = pts.shape[0]
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    rows = max(1, _NORMALS_PAIRS // max(n, 1))
    idx = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    for r0 in range(0, n, rows):
        p = pts[r0:r0 + rows]
        dx = p[:, 0:1] - px
        dy = p[:, 1:2] - py
        dz = p[:, 2:3] - pz
        d2 = (dx * dx + dy * dy) + dz * dz
        if valid is not None:
            d2 = torch.where(valid[None, :] & valid[r0:r0 + rows, None], d2, float("inf"))
        idx[r0:r0 + rows] = torch.topk(d2, k, dim=1, largest=False).indices
    return idx


def _pca_normals(nbrs: torch.Tensor, pts: torch.Tensor, viewpoint: torch.Tensor):
    """Normals (smallest-eigenvalue eigenvectors of the (M,k,3)
    neighbourhoods' covariances) oriented toward ``viewpoint`` from
    ``pts``, and curvatures."""
    X = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", X, X) / nbrs.shape[1]
    lam_min, normal = L3.eigvec_min_sym3(cov)
    flip = (normal * (viewpoint[None] - pts)).sum(-1) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    curvature = lam_min / torch.clamp_min(cov.diagonal(dim1=-2, dim2=-1).sum(-1), 1e-12)
    return normal, curvature


def estimate_normals(pts: torch.Tensor, valid: torch.Tensor, k: int = 8,
                     viewpoint: Optional[torch.Tensor] = None):
    """k-NN PCA normals of a (N,3) slab, oriented toward ``viewpoint``
    (the origin by default) -> (normals (N,3), zero where invalid;
    curvature (N,)). Exact brute-force k-NN among the valid points only:
    they are compacted in order (one host sync for their count), searched
    among themselves and scattered back, so a slab with few valid rows
    costs its valid rows squared. An invalid row reads the curvature of
    rows 0..k-1, the neighbours the JAX twin's ``top_k`` picks for a row
    with no valid pair. Neighbours tied in distance at the k-th place can
    be picked in another order than by the twin's ``top_k``: only
    duplicated points tie exactly, and copies give the same covariance."""
    if viewpoint is None:
        viewpoint = torch.zeros((3,), dtype=pts.dtype, device=pts.device)
    rows = torch.nonzero(valid)[:, 0]
    if rows.numel() < k:   # fewer valid points than neighbours: pairs with invalid ones
        normal, curvature = _pca_normals(pts[_knn_blocked(pts, valid, k)], pts, viewpoint)
        return torch.where(valid[:, None], normal, torch.zeros_like(normal)), curvature
    sub = pts[rows]
    normal_v, curv_v = _pca_normals(sub[_knn_blocked(sub, None, k)], sub, viewpoint)
    _, curv_inv = _pca_normals(pts[None, :k], pts[:1], viewpoint)
    normal = torch.zeros_like(pts).index_copy_(0, rows, normal_v)
    curvature = curv_inv.expand(pts.shape[0]).clone().index_copy_(0, rows, curv_v)
    return normal, curvature


def normals_from_depth(depth: torch.Tensor, cam: C.CameraModel):
    """Organized normals from the cross product of image-gradient tangents,
    oriented toward the camera."""
    pts, ok = cloud_from_depth(depth, cam)
    H, W = depth.shape
    P = pts.reshape(H, W, 3)
    dx = torch.roll(P, -1, dims=1) - torch.roll(P, 1, dims=1)
    dy = torch.roll(P, -1, dims=0) - torch.roll(P, 1, dims=0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)
    flip = (n * P).sum(-1) > 0
    n = torch.where(flip[..., None], -n, n)
    return n.reshape(-1, 3), ok


def range_filter(pts: torch.Tensor, valid: torch.Tensor, min_range: float = 0.0,
                 max_range: float = 0.0) -> torch.Tensor:
    r = torch.linalg.norm(pts, dim=-1)
    ok = valid
    if min_range > 0:
        ok = ok & (r >= min_range)
    if max_range > 0:
        ok = ok & (r <= max_range)
    return ok


def crop_box(pts: torch.Tensor, valid: torch.Tensor, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=pts.dtype, device=pts.device)
    hi = torch.as_tensor(hi, dtype=pts.dtype, device=pts.device)
    return valid & ((pts >= lo) & (pts <= hi)).all(dim=-1)


def random_subsample(pts: torch.Tensor, valid: torch.Tensor, target: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Keep at most ``target`` valid points (mask update); the scores come
    from ``generator`` (on the points' device)."""
    n = pts.shape[0]
    score = (torch.rand((n,), generator=generator, device=pts.device)
             + (~valid).to(pts.dtype) * 10.0)
    thresh = torch.sort(score).values[min(target, n) - 1]
    return valid & (score <= thresh)

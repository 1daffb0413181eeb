"""Pairwise visual registration: match + robust motion estimation.

Port of ``rtabmap_tpu/ops/registration.py`` (the reference's
``RegistrationVis``: NNDR feature correspondences, an optional
guess-projected window, then ``Vis/EstimationType`` 1 = PnP-RANSAC or
0 = 3D->3D Kabsch RANSAC). The RANSAC's sample indices come from a CPU
``torch.Generator`` or are passed in (``indices=``), so a parity test can
inject the JAX twin's own draws.

Convention: ``register_frames(A, B)`` returns ``T_ab`` with
``pose_B = pose_A @ T_ab``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import ransac as R


class RegistrationResult(NamedTuple):
    transform: torch.Tensor    # (3,4) T_ab
    valid: torch.Tensor        # () bool
    num_matches: torch.Tensor  # () int32
    num_inliers: torch.Tensor  # () int32
    covariance: torch.Tensor   # (6,6)
    inlier_mask: torch.Tensor  # (K,) on B's keypoints
    match_idx: torch.Tensor    # (K,) B->A match indices


def register_frames(a: FrameFeatures, b: FrameFeatures, cam: C.CameraModel,
                    generator: Optional[torch.Generator] = None,
                    guess: Optional[torch.Tensor] = None, estimation_type: int = 1,
                    nndr: float = 0.8, reproj_px: float = 4.0, inlier_dist: float = 0.1,
                    min_inliers: int = 20, ransac_iters: int = 256, window: float = 0.0,
                    indices: Optional[Tuple[torch.Tensor, ...]] = None
                    ) -> RegistrationResult:
    """Estimate T_ab from features: B's descriptors matched to A's 3D
    keypoints (NNDR), then ``estimation_type`` 1 = PnP (B observes A's 3D
    points, with B's own 3D for the Kabsch hypotheses) or 0 = 3D->3D
    Kabsch RANSAC. With ``guess`` (B-in-A) and ``window`` > 0 a match must
    land within ``window`` pixels of A's point projected into B through
    the guess. ``indices`` replaces the drawn samples: the pair of
    ``ransac.pnp_sample_indices`` for type 1, (iters, 3) for type 0."""
    m = M.match_nndr(b.desc, b.valid, a.desc, a.valid & a.valid3d, nndr=nndr)
    idx = m.idx.long()
    if guess is not None and window > 0.0:
        uv_pred, _ = C.project(T.apply(T.inverse(guess), a.pts3d), cam)
        du = uv_pred[idx] - b.uv
        m = m._replace(valid=m.valid & ((du * du).sum(-1) <= window * window))
    n_matches = m.valid.sum()
    pts_a = a.pts3d[idx]               # matched A 3D (A's camera frame)
    if estimation_type == 0:
        res = R.ransac_rigid(pts_a, b.pts3d, m.valid & b.valid3d, generator,
                             iters=ransac_iters, threshold=inlier_dist,
                             min_inliers=min_inliers,
                             indices=None if indices is None else indices[0])
        # dst ~ T(src) maps A-frame points into B's frame: the motion A->B
        # is its inverse
        t_ab = T.inverse(res.transform)
    else:
        res = R.ransac_pnp(pts_a, b.uv, m.valid, cam, generator, iters=ransac_iters,
                           reproj_px=reproj_px, min_inliers=min_inliers, guess=guess,
                           pts3d_query=torch.where(b.valid3d[:, None], b.pts3d, 0.0),
                           indices=indices)
        t_ab = res.transform           # camera-B pose in A's frame
    return RegistrationResult(
        transform=t_ab, valid=res.success & (n_matches >= min_inliers),
        num_matches=n_matches.to(torch.int32), num_inliers=res.num_inliers,
        covariance=res.covariance, inlier_mask=res.inliers, match_idx=m.idx)

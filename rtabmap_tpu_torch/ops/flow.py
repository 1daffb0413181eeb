"""Pyramidal Lucas-Kanade feature tracking (2-D KLT).

Port of ``rtabmap_tpu/ops/flow.py`` (the reference's ``Vis/CorType=1``
optical-flow correspondences, cv::calcOpticalFlowPyrLK): every feature is
tracked at once, a fixed number of Gauss-Newton steps a pyramid level on
the closed-form 2x2 normal equations; a step's five patches (current,
+-0.5 px in x and in y) are one gather.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rtabmap_tpu_torch.ops import image as im
from rtabmap_tpu_torch.ops.stereo import _lk_offsets, _patch_sample, _shifted_patches

_SHIFTS = ((0.0, 0.0), (0.5, 0.0), (-0.5, 0.0), (0.0, 0.5), (0.0, -0.5))


def klt_track(prev: torch.Tensor, nxt: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
              guess_uv: Optional[torch.Tensor] = None, levels: int = 3, iters: int = 8,
              win: int = 3, max_err: float = 0.08, max_move: float = 100.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track uv (K,2) from ``prev`` into ``nxt``: (uv2 (K,2), ok (K,)).
    ``guess_uv`` seeds the search (e.g. map points projected under a
    motion guess)."""
    offs = _lk_offsets(win, uv.device)
    shifts = torch.tensor(_SHIFTS, device=uv.device)
    pyr_p = im.pyramid(prev, levels)
    pyr_n = im.pyramid(nxt, levels)
    d = ((guess_uv - uv) if guess_uv is not None else torch.zeros_like(uv)) \
        * (0.5 ** (levels - 1))
    for lvl in range(levels - 1, -1, -1):
        uv_l = uv * (0.5 ** lvl)
        tpl = _patch_sample(pyr_p[lvl], uv_l, offs)
        Nl = pyr_n[lvl]
        for _ in range(iters):
            cur, xp, xm, yp, ym = _shifted_patches(Nl, uv_l + d, shifts, offs)
            gx, gy = xp - xm, yp - ym
            err = cur - tpl
            a = (gx * gx).sum(-1) + 1e-9
            b = (gx * gy).sum(-1)
            c = (gy * gy).sum(-1) + 1e-9
            e1 = (gx * err).sum(-1)
            e2 = (gy * err).sum(-1)
            det = torch.clamp_min(a * c - b * b, 1e-12)
            step = torch.stack([(c * e1 - b * e2) / det, (a * e2 - b * e1) / det], dim=-1)
            d = d - torch.clamp(step, -2.0, 2.0)
        if lvl > 0:
            d = d * 2.0
    uv2 = uv + d
    res = _patch_sample(pyr_p[0], uv, offs) - _patch_sample(pyr_n[0], uv2, offs)
    rms = torch.sqrt((res * res).mean(-1))
    H, W = prev.shape[-2:]
    ok = (valid & (rms < max_err) & (torch.linalg.norm(d, dim=-1) < max_move)
          & (uv2[:, 0] >= 0) & (uv2[:, 0] < W - 1) & (uv2[:, 1] >= 0) & (uv2[:, 1] < H - 1))
    return uv2, ok

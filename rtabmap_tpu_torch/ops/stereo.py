"""Stereo correspondence: sparse pyramidal LK along the epipolar line and
dense block matching / semi-global matching.

Port of ``rtabmap_tpu/ops/stereo.py`` (the reference's
``calcOpticalFlowPyrLKStereo`` for keypoint disparities, ``StereoBM`` and
``StereoSGBM``). The sparse matcher tracks all keypoints at once: a fixed
number of Gauss-Newton steps per pyramid level, each one gather of the
current, +0.5 px and -0.5 px patches together. The dense matchers build
the (D,H,W) cost volume by shifting the right image; SGBM aggregates it
along four scanlines, one Python step per column or row with the whole
perpendicular line and every disparity at once (the twin's ``lax.scan``).
All of it is plain PyTorch: the twin has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.ops import image as im


def _patch_sample(img: torch.Tensor, uv: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Sample (K,P) patch values at uv (K,2) + offs (P,2)."""
    pts = uv[:, None, :] + offs[None]
    return im.bilinear_sample(img, pts.reshape(-1, 2)).reshape(uv.shape[0], -1)


def _lk_offsets(r: int, device=None) -> torch.Tensor:
    """(P,2) window offsets (x, y), rows outer: P = (2r+1)^2."""
    ax = torch.arange(-r, r + 1.0, device=device)
    ys, xs = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def _shifted_patches(img: torch.Tensor, uv: torch.Tensor, shifts: torch.Tensor,
                     offs: torch.Tensor) -> torch.Tensor:
    """Patches at uv + each of ``shifts`` (S,2) in one gather: (S,K,P);
    each point's value is the one ``_patch_sample`` gives."""
    pts = (uv[None] + shifts[:, None, :]).reshape(-1, 2)
    return _patch_sample(img, pts, offs).reshape(shifts.shape[0], uv.shape[0], -1)


def lk_stereo_disparity(left: torch.Tensor, right: torch.Tensor, uv: torch.Tensor,
                        valid: torch.Tensor, max_disparity: float = 128.0,
                        levels: int = 3, iters: int = 8, win: int = 3,
                        max_err: float = 0.08) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D Lucas-Kanade along the epipolar line of a rectified pair.

    uv (K,2) keypoints in the LEFT image -> (disparity (K,), ok (K,)),
    coarse to fine over a ``levels`` pyramid, ``iters`` steps a level."""
    offs = _lk_offsets(win, uv.device)
    shifts = torch.tensor(((0.0, 0.0), (0.5, 0.0), (-0.5, 0.0)), device=uv.device)
    pyr_l = im.pyramid(left, levels)
    pyr_r = im.pyramid(right, levels)
    d = torch.zeros(uv.shape[0], dtype=uv.dtype, device=uv.device)
    for lvl in range(levels - 1, -1, -1):
        uv_l = uv * (0.5 ** lvl)
        tpl = _patch_sample(pyr_l[lvl], uv_l, offs)
        R = pyr_r[lvl]
        for _ in range(iters):
            uv_r = uv_l - torch.stack([d, torch.zeros_like(d)], dim=-1)
            cur, plus, minus = _shifted_patches(R, uv_r, shifts, offs)
            gx = plus - minus
            err = cur - tpl
            num = (gx * err).sum(-1)
            den = torch.clamp_min((gx * gx).sum(-1), 1e-9)
            d = d + torch.clamp(num / den, -2.0, 2.0)
        if lvl > 0:
            d = d * 2.0
    uv_r = uv - torch.stack([d, torch.zeros_like(d)], dim=-1)
    res = _patch_sample(pyr_l[0], uv, offs) - _patch_sample(pyr_r[0], uv_r, offs)
    rms = torch.sqrt((res * res).mean(-1))
    ok = valid & (d > 0.25) & (d < max_disparity) & (rms < max_err) & (uv_r[:, 0] >= 0)
    return torch.where(ok, d, torch.zeros_like(d)), ok


def _second_smallest(vol: torch.Tensor) -> torch.Tensor:
    """The second-smallest value along axis 0 (``jnp.partition(v, 1)[1]``)."""
    return torch.kthvalue(vol, 2, dim=0).values


def _valid_columns(okay: torch.Tensor, D: int) -> torch.Tensor:
    """Hide the left D columns, where ``torch.roll`` wrapped the right image."""
    col = torch.arange(okay.shape[-1], device=okay.device)[None, :]
    return okay & (col >= D)


def dense_bm_disparity(left: torch.Tensor, right: torch.Tensor, max_disparity: int = 64,
                       block: int = 9, uniqueness: float = 0.95) -> torch.Tensor:
    """Dense block matching: SAD = boxfilter(|L - shift(R, d)|) for each d,
    the arg-min (ties to the lowest d) with a uniqueness check against the
    second-best SAD. Float disparity (H,W), 0 where invalid."""
    k = np.ones((block,), np.float32) / block
    sads = torch.stack([im._sep_conv((left - torch.roll(right, d, dims=-1)).abs(), k, k)
                        for d in range(max_disparity)], dim=0)
    best_v = sads.min(dim=0).values
    best = torch.argmin(sads, dim=0)
    okay = (best_v < uniqueness * _second_smallest(sads)) & (best > 0)
    okay = _valid_columns(okay, max_disparity)
    return torch.where(okay, best.to(torch.float32), torch.zeros_like(best_v))


def _aggregate(costs: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """costs (L, D, M): the SGM recurrence along axis 0, every line of the
    perpendicular axis and every disparity at once."""
    big = torch.full_like(costs[0, :1], 1e9)
    prev = costs[0]
    out = [prev]
    for c in costs[1:]:
        m = prev.min(dim=0).values[None]
        up = torch.cat([big, prev[:-1]], dim=0)      # roll(prev, 1), row 0 = 1e9
        dn = torch.cat([prev[1:], big], dim=0)       # roll(prev, -1), last = 1e9
        best = torch.minimum(torch.minimum(prev, up + p1), torch.minimum(dn + p1, m + p2))
        prev = c + best - m
        out.append(prev)
    return torch.stack(out, dim=0)


def dense_sgbm_disparity(left: torch.Tensor, right: torch.Tensor, max_disparity: int = 64,
                         p1: float = 0.03, p2: float = 0.2,
                         uniqueness: float = 0.95) -> torch.Tensor:
    """Semi-global matching over four scanlines (left->right, right->left,
    top->bottom, bottom->top) on the cost 0.7 |L - R_d| + 0.3 |dL - dR_d|
    (horizontal gradients), the uniqueness check of ``dense_bm_disparity``
    and a parabolic subpixel offset on the aggregated cost."""
    D = max_disparity
    gl = left - torch.roll(left, 1, dims=-1)

    def cost_for(d):
        shifted = torch.roll(right, d, dims=-1)
        gr = shifted - torch.roll(shifted, 1, dims=-1)
        return 0.7 * (left - shifted).abs() + 0.3 * (gl - gr).abs()

    cost = torch.stack([cost_for(d) for d in range(D)], dim=0)          # (D,H,W)
    cw = cost.permute(2, 0, 1)                                          # (W,D,H)
    ch = cost.permute(1, 0, 2)                                          # (H,D,W)
    lr = _aggregate(cw, p1, p2).permute(1, 2, 0)
    rl = _aggregate(cw.flip(0), p1, p2).flip(0).permute(1, 2, 0)
    tb = _aggregate(ch, p1, p2).permute(1, 0, 2)
    bt = _aggregate(ch.flip(0), p1, p2).flip(0).permute(1, 0, 2)
    total = lr + rl + tb + bt                                           # (D,H,W)

    best_v = total.min(dim=0).values
    best = torch.argmin(total, dim=0)
    okay = (best_v < uniqueness * _second_smallest(total)) & (best > 0)
    okay = _valid_columns(okay, D)
    bm1 = torch.gather(total, 0, (best - 1).clamp(0, D - 1)[None])[0]
    bp1 = torch.gather(total, 0, (best + 1).clamp(0, D - 1)[None])[0]
    denom = bm1 + bp1 - 2.0 * best_v
    safe = torch.where(denom.abs() > 1e-9, denom, torch.ones_like(denom))
    off = torch.where(denom.abs() > 1e-9, 0.5 * (bm1 - bp1) / safe, torch.zeros_like(denom))
    disp = best.to(torch.float32) + off.clamp(-0.5, 0.5)
    return torch.where(okay, disp, torch.zeros_like(disp))


def keypoints_3d_from_stereo(kps_uv: torch.Tensor, kps_valid: torch.Tensor,
                             left: torch.Tensor, right: torch.Tensor, stereo_model,
                             max_depth: float = 40.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoints' camera-frame 3D from their LK disparities (the
    reference's Feature2D::generateKeypoints3D stereo path): (pts (K,3),
    ok (K,)), zero where not ok."""
    from rtabmap_tpu_torch.geometry import camera as C

    disp, ok = lk_stereo_disparity(left, right, kps_uv, kps_valid)
    depth = C.disparity_to_depth(disp, stereo_model)
    ok = ok & (depth > 0) & (depth < max_depth)
    pts = C.backproject(kps_uv, depth, stereo_model.left)
    return torch.where(ok[:, None], pts, torch.zeros_like(pts)), ok

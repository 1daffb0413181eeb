"""GFTT keypoints + rotated-BRIEF +-1 descriptors, statically shaped.

Port of the GFTT/BRIEF path of ``rtabmap_tpu/ops/features.py``: the
Shi-Tomasi response, NMS + gridded exact top-k, 3x3 subpixel refinement,
gradient orientation, the 30-bin rotated BRIEF test set (the same numpy
seed) and the depth lookup of keypoints. Harris, DoG, FAST and the SIFT
descriptor wait for a later slice.

Descriptors are 256-D sign vectors (+-1, int8) so that descriptor distance
and vocabulary quantization are integer dot products:
``hamming = (D - a.b) / 2``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.ops import image as im

DESC_DIM = 256
PATCH_R = 15  # half-patch for orientation + description


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set. Invalid slots have valid=False; every
    consumer masks on ``valid``."""

    uv: torch.Tensor        # (K,2) float32 pixel coords (x=u, y=v)
    response: torch.Tensor  # (K,) float32 detector score
    angle: torch.Tensor     # (K,) float32 radians
    octave: torch.Tensor    # (K,) int32 pyramid level
    valid: torch.Tensor     # (K,) bool


def shi_tomasi_response(gray: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """GFTT min-eigenvalue response map over (...,H,W)."""
    gx, gy = im.sobel(gray)
    gxx = im.gaussian_blur(gx * gx, sigma)
    gyy = im.gaussian_blur(gy * gy, sigma)
    gxy = im.gaussian_blur(gx * gy, sigma)
    tr = gxx + gyy
    det_term = torch.sqrt(torch.clamp((gxx - gyy) ** 2 + 4.0 * gxy * gxy, min=0.0))
    return 0.5 * (tr - det_term)


def _peaks_top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, equal scores in increasing index
    order (what ``lax.top_k`` gives; ``torch.topk`` promises no order among
    ties, a stable descending sort does)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _peak_map(score: torch.Tensor, nms_size: int, border: int) -> torch.Tensor:
    H, W = score.shape[-2:]
    local_max = im.max_pool_same(score, nms_size)
    vmask = torch.zeros((H, W), dtype=torch.bool, device=score.device)
    vmask[border:H - border, border:W - border] = True
    return torch.where((score >= local_max) & (score > 0) & vmask, score,
                       torch.full_like(score, -float("inf")))


def _keypoints(uv, vals, quality_level: float, k: int) -> Keypoints:
    max_v = torch.clamp(torch.max(vals), min=1e-12)
    valid = (vals > quality_level * max_v) & torch.isfinite(vals)
    dev = uv.device
    return Keypoints(
        uv=uv, response=torch.where(valid, vals, torch.zeros_like(vals)),
        angle=torch.zeros((k,), dtype=torch.float32, device=dev),
        octave=torch.zeros((k,), dtype=torch.int32, device=dev), valid=valid)


def select_top_k(score: torch.Tensor, k: int, nms_size: int = 7,
                 quality_level: float = 0.01, border: int = PATCH_R + 1) -> Keypoints:
    """NMS + global top-k on a (H,W) score map."""
    W = score.shape[-1]
    vals, idx = _peaks_top_k(_peak_map(score, nms_size, border).reshape(-1), k)
    uv = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return _keypoints(uv, vals, quality_level, k)


def select_top_k_grid(score: torch.Tensor, k: int, grid: Tuple[int, int] = (4, 4),
                      nms_size: int = 7, quality_level: float = 0.01,
                      border: int = PATCH_R + 1) -> Keypoints:
    """Spatially-distributed selection: top-(k/cells) per grid cell
    (reference: Kp/GridRows x Kp/GridCols)."""
    H, W = score.shape[-2:]
    gr, gc = grid
    per_cell = max(k // (gr * gc), 1)
    peak = _peak_map(score, nms_size, border)
    ch, cw = H // gr, W // gc
    cells = (peak[: gr * ch, : gc * cw].reshape(gr, ch, gc, cw)
             .permute(0, 2, 1, 3).reshape(gr * gc, ch * cw))
    vals, idx = _peaks_top_k(cells, per_cell)            # (cells, per_cell)
    cell_ids = torch.arange(gr * gc, device=score.device)
    oy = (cell_ids // gc * ch)[:, None]
    ox = (cell_ids % gc * cw)[:, None]
    uv = torch.stack([(idx % cw + ox).float(), (idx // cw + oy).float()],
                     dim=-1).reshape(-1, 2)
    vals = vals.reshape(-1)
    max_v = torch.clamp(torch.max(vals), min=1e-12)
    valid = (vals > quality_level * max_v) & torch.isfinite(vals)
    pad = k - uv.shape[0]
    if pad > 0:
        uv = torch.cat([uv, uv.new_zeros((pad, 2))])
        vals = torch.cat([vals, vals.new_zeros((pad,))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    else:
        # keep the overall best k
        order = _peaks_top_k(torch.where(valid, vals, torch.full_like(vals, -float("inf"))), k)[1]
        uv, vals, valid = uv[order], vals[order], valid[order]
    dev = score.device
    return Keypoints(uv=uv, response=torch.where(valid, vals, torch.zeros_like(vals)),
                     angle=torch.zeros((k,), dtype=torch.float32, device=dev),
                     octave=torch.zeros((k,), dtype=torch.int32, device=dev),
                     valid=valid)


def refine_subpixel(score: torch.Tensor, kps: Keypoints) -> Keypoints:
    """Quadratic 3x3 subpixel refinement on the score map, offsets clamped
    to +-0.6 px (reference: Kp/SubPixWinSize)."""
    H, W = score.shape[-2:]
    u = kps.uv[:, 0].long()
    v = kps.uv[:, 1].long()
    rr = torch.arange(-1, 2, device=score.device)
    rows = (v[:, None] + rr[None, :]).clamp(0, H - 1)      # (K,3)
    cols = (u[:, None] + rr[None, :]).clamp(0, W - 1)
    nb = score[rows[:, :, None], cols[:, None, :]]         # (K,3,3) [dv+1,du+1]
    c = nb[:, 1, 1]
    dx = 0.5 * (nb[:, 1, 2] - nb[:, 1, 0])
    dy = 0.5 * (nb[:, 2, 1] - nb[:, 0, 1])
    dxx = nb[:, 1, 2] + nb[:, 1, 0] - 2 * c
    dyy = nb[:, 2, 1] + nb[:, 0, 1] - 2 * c
    zero = torch.zeros_like(dx)
    off_u = torch.where(dxx.abs() > 1e-12, -dx / dxx, zero)
    off_v = torch.where(dyy.abs() > 1e-12, -dy / dyy, zero)
    off = torch.stack([off_u.clamp(-0.6, 0.6), off_v.clamp(-0.6, 0.6)], dim=-1)
    return kps._replace(uv=torch.where(kps.valid[:, None], kps.uv + off, kps.uv))


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floored modulo with the sign of ``y`` (``jnp.mod``'s rule)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def compute_orientation(gray: torch.Tensor, kps: Keypoints) -> Keypoints:
    """Per-keypoint orientation: direction of the heavily smoothed image
    gradient at the keypoint (the JAX package's default ``gradient``
    method)."""
    gx, gy = im.sobel(im.gaussian_blur(gray, sigma=4.0, radius=6))
    angle = torch.atan2(im.sample_at(gy, kps.uv), im.sample_at(gx, kps.uv))
    return kps._replace(angle=torch.where(kps.valid, angle, torch.zeros_like(angle)))


# ----------------------------------------------------------------- description


def _brief_pattern(dim: int = DESC_DIM, radius: int = PATCH_R - 2, seed: int = 7):
    """Deterministic Gaussian BRIEF test pattern (the JAX package's seed)."""
    rng = np.random.RandomState(seed)
    sigma = radius / 2.5
    pts = np.clip(rng.randn(dim, 4) * sigma, -radius, radius).astype(np.float32)
    return pts  # (dim, [x1,y1,x2,y2])


_PATTERN = _brief_pattern()
_PATCH = 32          # descriptor patch side; center at (16,16)
_N_ANGLE_BINS = 30   # ORB quantizes rotation to 2*pi/30


def _binned_test_indices(n_bins: int = _N_ANGLE_BINS) -> np.ndarray:
    """(n_bins, 256, 2) flattened patch indices of the two rotated points
    of every BRIEF test. Test t of bin b is sign(patch[i1] - patch[i2]) —
    the gather form of the JAX package's +1/-1 difference matrices
    ``_binned_test_matrices`` (same rotation and rounding)."""
    out = np.zeros((n_bins, DESC_DIM, 2), np.int64)
    c = _PATCH // 2
    for b in range(n_bins):
        ang = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(ang), np.sin(ang)
        for t in range(DESC_DIM):
            x1, y1, x2, y2 = _PATTERN[t]
            for j, (x, y) in enumerate(((x1, y1), (x2, y2))):
                rx = int(np.round(ca * x - sa * y)) + c
                ry = int(np.round(sa * x + ca * y)) + c
                rx = min(max(rx, 0), _PATCH - 1)
                ry = min(max(ry, 0), _PATCH - 1)
                out[b, t, j] = ry * _PATCH + rx
    return out


_TEST_IDX = _binned_test_indices()
_TEST_IDX_DEV = {}


def describe(gray_blur: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """Rotated-BRIEF sign descriptors: (K, 256) int8 in {-1,+1}, 0 rows for
    invalid keypoints. One 32x32 patch per keypoint at round(uv), values
    rounded to bfloat16 as the JAX package's patch products do; the
    orientation picks one of 30 rotated test sets."""
    H, W = gray_blur.shape[-2:]
    dev = gray_blur.device
    tests = _TEST_IDX_DEV.get(str(dev))
    if tests is None:
        tests = _TEST_IDX_DEV[str(dev)] = torch.from_numpy(_TEST_IDX).to(dev)
    c = _PATCH // 2
    u0 = (torch.round(kps.uv[:, 0]).long() - c).clamp(0, W - _PATCH)
    v0 = (torch.round(kps.uv[:, 1]).long() - c).clamp(0, H - _PATCH)
    two_pi = 2.0 * np.pi
    bins = torch.round(_mod(kps.angle, two_pi) / two_pi * _N_ANGLE_BINS).long() % _N_ANGLE_BINS
    t = tests[bins]                                        # (K,256,2)
    rows = v0[:, None, None] + t // _PATCH
    cols = u0[:, None, None] + t % _PATCH
    img = gray_blur.to(torch.bfloat16).float()
    p = img[rows, cols]                                    # (K,256,2)
    bits = torch.where(p[..., 0] - p[..., 1] > 0, 1, -1).to(torch.int8)
    return torch.where(kps.valid[:, None], bits, torch.zeros_like(bits))


# ------------------------------------------------------------------- 3D lookup


def keypoints_3d_from_depth(kps: Keypoints, depth: torch.Tensor, cam,
                            min_depth: float = 0.1, max_depth: float = 20.0):
    """Depth-image lookup -> camera-frame 3D points (K,3) + validity."""
    from rtabmap_tpu_torch.geometry import camera as C

    z = im.sample_at(depth, kps.uv, pad_value=0.0)
    ok = kps.valid & (z > min_depth) & (z < max_depth)
    pts = C.backproject(kps.uv, z, cam)
    return torch.where(ok[:, None], pts, torch.zeros_like(pts)), ok


# --------------------------------------------------------------------- facade


def detect_and_describe(gray: torch.Tensor, max_kp: int, use_grid: bool = True,
                        grid: Tuple[int, int] = (4, 4), quality_level: float = 0.01,
                        nms_size: int = 7, subpixel: bool = True,
                        detector: str = "gftt", descriptor: str = "brief"):
    """Score map -> NMS top-k -> orientation -> descriptor. Returns
    (Keypoints, desc (K,256) +-1 int8). Orientation and descriptor are
    sampled at the integer peak; the subpixel offset is applied after, for
    geometry only."""
    if detector != "gftt" or descriptor != "brief":
        raise NotImplementedError(
            f"detector {detector!r} / descriptor {descriptor!r}: only GFTT/BRIEF "
            "is ported; Harris, DoG, FAST and SIFT come with a later slice")
    score = shi_tomasi_response(gray)
    if use_grid:
        kps = select_top_k_grid(score, max_kp, grid, nms_size, quality_level)
    else:
        kps = select_top_k(score, max_kp, nms_size, quality_level)
    kps = compute_orientation(gray, kps)
    desc = describe(im.gaussian_blur(gray, sigma=2.0, radius=4), kps)
    if subpixel:
        kps = refine_subpixel(score, kps)
    return kps, desc

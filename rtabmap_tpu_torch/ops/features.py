"""GFTT keypoints + rotated-BRIEF +-1 descriptors, statically shaped.

Port of ``rtabmap_tpu/ops/features.py``: the response maps (Shi-Tomasi,
Harris, difference of Gaussians, the dense FAST ring score, and detectors
plugged in with ``register_detector``), NMS + gridded exact top-k, 3x3
subpixel refinement, gradient orientation, the 30-bin rotated BRIEF test
set (the same numpy seed), the SIFT-family gradient-histogram descriptor
and the depth lookup of keypoints.

Binary descriptors are 256-D sign vectors (+-1, int8) so that descriptor
distance and vocabulary quantization are integer dot products:
``hamming = (D - a.b) / 2``; the SIFT descriptor is (K,128) float32.
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


def harris_response(gray: torch.Tensor, sigma: float = 1.5, k: float = 0.04) -> torch.Tensor:
    """Harris corner response det(M) - k*tr(M)^2 (reference: the
    cv::cornerHarris path of GFTT)."""
    gx, gy = im.sobel(gray)
    gxx = im.gaussian_blur(gx * gx, sigma)
    gyy = im.gaussian_blur(gy * gy, sigma)
    gxy = im.gaussian_blur(gx * gy, sigma)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def dog_response(gray: torch.Tensor, sigma1: float = 1.0, sigma2: float = 1.6) -> torch.Tensor:
    """|difference of Gaussians| blob response (the SIFT/KAZE-family
    detector at the base octave)."""
    g1 = im.gaussian_blur(gray, sigma1)
    g2 = im.gaussian_blur(gray, sigma2, radius=4)
    return torch.abs(g1 - g2)


# FAST's 16-pixel Bresenham ring of radius 3, as (dx, dy)
_FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def fast_response(gray: torch.Tensor, ring_r: int = 3) -> torch.Tensor:
    """FAST-like corner score over (...,H,W): the sum over the 16 ring
    pixels of how far each differs from the centre beyond a 0.04 margin
    (the image zero-padded by 3), computed densely with shifts."""
    H, W = gray.shape[-2:]
    pad = 3
    padded = torch.nn.functional.pad(gray, (pad, pad, pad, pad))
    score = torch.zeros_like(gray)
    t = 0.04
    for dx, dy in _FAST_RING:
        shifted = padded[..., pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        score = score + torch.clamp(torch.abs(shifted - gray) - t, min=0.0)
    return score


RESPONSE_FNS = {
    "gftt": shi_tomasi_response,
    "harris": harris_response,
    "dog": dog_response,
    "fast": fast_response,
}


def register_detector(name: str, response_fn):
    """Plug in a custom response-map detector (the reference's PyDetector
    hook): a plugin is a function from a (H,W) tensor to a (H,W) score
    tensor on the same device."""
    RESPONSE_FNS[name] = response_fn


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


def _on_device(cache: dict, host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``host`` as a tensor on ``dev``, copied once a device."""
    t = cache.get(str(dev))
    if t is None:
        t = cache[str(dev)] = torch.from_numpy(host).to(dev)
    return t


def _patch_origin(uv: torch.Tensor, H: int, W: int, patch: int):
    """Top-left corner (u0, v0) of each keypoint's patch centred at
    round(uv), clamped inside the image."""
    c = patch // 2
    u0 = (torch.round(uv[:, 0]).long() - c).clamp(0, W - patch)
    v0 = (torch.round(uv[:, 1]).long() - c).clamp(0, H - patch)
    return u0, v0


def extract_patches(img: torch.Tensor, uv: torch.Tensor, patch: int = _PATCH) -> torch.Tensor:
    """(K,patch,patch) float32 patches centred at round(uv) (clamped inside
    the image), of the image's values rounded to bfloat16: the JAX twin
    selects them with one-hot bfloat16 products, which round each value
    once and add nothing else."""
    H, W = img.shape[-2:]
    u0, v0 = _patch_origin(uv, H, W, patch)
    rr = torch.arange(patch, device=img.device)
    rows = (v0[:, None] + rr)[:, :, None]                  # (K,patch,1)
    cols = (u0[:, None] + rr)[:, None, :]                  # (K,1,patch)
    return img.to(torch.bfloat16).float()[rows, cols]


def describe(gray_blur: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """Rotated-BRIEF sign descriptors: (K, 256) int8 in {-1,+1}, 0 rows for
    invalid keypoints. One 32x32 patch per keypoint at round(uv), values
    rounded to bfloat16 as the JAX package's patch products do; the
    orientation picks one of 30 rotated test sets."""
    H, W = gray_blur.shape[-2:]
    tests = _on_device(_TEST_IDX_DEV, _TEST_IDX, gray_blur.device)
    u0, v0 = _patch_origin(kps.uv, H, W, _PATCH)
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
    """Score map -> NMS top-k -> orientation -> descriptor. ``detector``
    names a response map of ``RESPONSE_FNS`` (gftt | harris | dog | fast or
    a registered plugin); ``descriptor`` is "brief" ((K,256) +-1 int8) or
    "sift" ((K,128) float32, matched with metric="l2"). Returns
    (Keypoints, desc). Orientation and descriptor are sampled at the
    integer peak; the subpixel offset is applied after, for geometry
    only."""
    if descriptor not in ("brief", "sift"):
        raise KeyError(f"unknown descriptor {descriptor!r}; use 'brief' or 'sift'")
    score = RESPONSE_FNS[detector](gray)
    if use_grid:
        kps = select_top_k_grid(score, max_kp, grid, nms_size, quality_level)
    else:
        kps = select_top_k(score, max_kp, nms_size, quality_level)
    kps = compute_orientation(gray, kps)
    blur = im.gaussian_blur(gray, sigma=2.0, radius=4)
    desc = describe(blur, kps) if descriptor == "brief" else describe_sift(blur, kps)
    if subpixel:
        kps = refine_subpixel(score, kps)
    return kps, desc


# --------------------------------------------- SIFT-family float descriptor


_SIFT_CELLS = 4       # 4x4 spatial grid
_SIFT_ORI = 8         # orientation bins
SIFT_DIM = _SIFT_CELLS * _SIFT_CELLS * _SIFT_ORI   # 128


def _sift_spatial_weights(n_bins: int = _N_ANGLE_BINS) -> np.ndarray:
    """Per-orientation-bin spatial pooling matrices (n_bins, patch^2, 16):
    rotated, Gaussian-weighted bilinear assignment of each patch pixel to
    the 4x4 descriptor grid (built with numpy exactly as the JAX twin
    builds it)."""
    out = np.zeros((n_bins, _PATCH * _PATCH, _SIFT_CELLS * _SIFT_CELLS), np.float32)
    c = (_PATCH - 1) / 2.0
    half = _PATCH / 2.0
    sigma = 0.5 * _PATCH
    for b in range(n_bins):
        ang = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(ang), np.sin(ang)
        for py in range(_PATCH):
            for px in range(_PATCH):
                x, y = px - c, py - c
                # rotate into the keypoint frame
                rx = ca * x + sa * y
                ry = -sa * x + ca * y
                g = np.exp(-(rx * rx + ry * ry) / (2 * sigma * sigma))
                # continuous cell coords in [0,4)
                cx = (rx + half) / _PATCH * _SIFT_CELLS - 0.5
                cy = (ry + half) / _PATCH * _SIFT_CELLS - 0.5
                x0, y0 = int(np.floor(cx)), int(np.floor(cy))
                fx, fy = cx - x0, cy - y0
                for dy, wy in ((0, 1 - fy), (1, fy)):
                    for dx, wx in ((0, 1 - fx), (1, fx)):
                        gx, gy = x0 + dx, y0 + dy
                        if 0 <= gx < _SIFT_CELLS and 0 <= gy < _SIFT_CELLS:
                            out[b, py * _PATCH + px, gy * _SIFT_CELLS + gx] += g * wy * wx
    return out


_SIFT_SPATIAL = _sift_spatial_weights()
_SIFT_SPATIAL_DEV = {}


def describe_sift(gray_blur: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """SIFT-family gradient-histogram descriptor: (K, 128) float32,
    L2-normalised with the 0.2 clip and renormalisation, 0 rows for
    invalid keypoints. Patch gradients by central differences, soft
    assignment of each pixel's gradient to 8 orientation bins relative to
    the keypoint angle, and rotated spatial pooling by the keypoint's
    orientation bin (one batched product)."""
    K = kps.uv.shape[0]
    patches = extract_patches(gray_blur, kps.uv)            # (K,P,P)
    zx = patches.new_zeros((K, _PATCH, 1))
    zy = patches.new_zeros((K, 1, _PATCH))
    gx = torch.cat([zx, patches[:, :, 2:] - patches[:, :, :-2], zx], dim=2)
    gy = torch.cat([zy, patches[:, 2:, :] - patches[:, :-2, :], zy], dim=1)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    theta = torch.atan2(gy, gx) - kps.angle[:, None, None]  # keypoint frame
    two_pi = 2.0 * np.pi
    t = _mod(theta, two_pi) / two_pi * _SIFT_ORI
    b0f = torch.floor(t)
    f = (t - b0f).reshape(K, -1, 1)
    b0 = (b0f.long() % _SIFT_ORI).reshape(K, -1, 1)
    b1 = (b0 + 1) % _SIFT_ORI
    obins = torch.arange(_SIFT_ORI, device=patches.device)
    w_ori = ((b0 == obins) * (1.0 - f) + (b1 == obins) * f) * mag.reshape(K, -1, 1)
    bins = torch.round(_mod(kps.angle, two_pi) / two_pi * _N_ANGLE_BINS).long() % _N_ANGLE_BINS
    wsp = _on_device(_SIFT_SPATIAL_DEV, _SIFT_SPATIAL, patches.device)[bins]   # (K,P2,16)
    desc = torch.bmm(wsp.transpose(1, 2), w_ori).reshape(K, SIFT_DIM)        # (K,16*8)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)
    return torch.where(kps.valid[:, None], desc, torch.zeros_like(desc))

"""2D image ops that GFTT/BRIEF extraction reaches.

Port of the matching parts of ``rtabmap_tpu/ops/image.py``: grayscale,
separable 'same' convolutions (Gaussian blur, Sobel), NMS max-pool and the
point samplers. Images are float32 ``(..., H, W)`` in [0,1].

The separable convolution keeps the JAX package's banded-matrix form: the
same (n, n) band matrices, one product per axis, so both packages sum the
same terms. Full float32 products on the card: with TF32 the blurred GFTT
response would move keypoints.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(...,H,W,3) uint8/float -> (...,H,W) float32 in [0,1]."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).float()


_BAND_CACHE: Dict[Tuple[bytes, int], np.ndarray] = {}
_BAND_DEV: Dict[Tuple[bytes, int, str], torch.Tensor] = {}


def _band(k: np.ndarray, n: int) -> np.ndarray:
    """(n,n) banded 'same'-zero-padding convolution matrix for 1-D kernel k:
    out[i] = sum_j k[j] * x[i + j - r]."""
    key = (k.tobytes(), n)
    hit = _BAND_CACHE.get(key)
    if hit is not None:
        return hit
    r = len(k) // 2
    B = np.zeros((n, n), np.float32)
    for j, kv in enumerate(k):
        d = j - r
        idx = np.arange(max(0, -d), min(n, n - d))
        B[idx, idx + d] = kv
    _BAND_CACHE[key] = B
    return B


def _band_t(k: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """Transposed band matrix on ``device`` (cached per device)."""
    key = (k.tobytes(), n, str(device))
    hit = _BAND_DEV.get(key)
    if hit is None:
        hit = torch.from_numpy(np.ascontiguousarray(_band(k, n).T)).to(device)
        _BAND_DEV[key] = hit
    return hit


def _sep_conv(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D convolution with 'same' zero padding on (...,H,W)."""
    H, W = img.shape[-2:]
    Bx_t = _band_t(np.asarray(kx, np.float32), W, img.device)
    By_t = _band_t(np.asarray(ky, np.float32), H, img.device)
    x = img @ Bx_t
    return (x.transpose(-1, -2) @ By_t).transpose(-1, -2)


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k = k / np.sum(k)
    return _sep_conv(img, k, k)


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) 3x3 Sobel gradients."""
    gx = _sep_conv(img, np.array([-0.5, 0.0, 0.5]), np.array([0.25, 0.5, 0.25]))
    gy = _sep_conv(img, np.array([0.25, 0.5, 0.25]), np.array([-0.5, 0.0, 0.5]))
    return gx, gy


def sample_at(img: torch.Tensor, uv: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """Bilinear sample of (H,W) at (N,2) continuous pixel coords — the
    values of the JAX package's ``bilinear_sample_mm`` (clamped taps, the
    weight of a tap past the last row/column is zero), by gathers instead
    of one-hot products. Points outside the image return ``pad_value``."""
    H, W = img.shape
    u = uv[:, 0].clamp(0.0, W - 1.0)
    v = uv[:, 1].clamp(0.0, H - 1.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    ui = u0.long()
    vi = v0.long()
    ui1 = (ui + 1).clamp(max=W - 1)
    vi1 = (vi + 1).clamp(max=H - 1)
    # a tap past the edge has weight 0 (du or dv is 0 there)
    col0 = img[vi, ui] * (1.0 - dv) + img[vi1, ui] * dv
    col1 = img[vi, ui1] * (1.0 - dv) + img[vi1, ui1] * dv
    z = col0 * (1.0 - du) + col1 * du
    ok = ((uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
          & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1))
    return torch.where(ok, z, torch.full_like(z, pad_value))


def max_pool_same(img: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter with 'same' (-inf) padding on (...,H,W) — used for NMS."""
    batch = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    out = F.max_pool2d(x, size, stride=1, padding=size // 2)
    return out.reshape(*batch, H, W)

"""Descriptor similarity and exact blocked k-NN for +-1 int8 descriptors.

Port of ``rtabmap_tpu/ops/matching.py``: ``similarity_matrix``,
``hamming_matrix``, ``knn_blocked`` (the plain version of the vocabulary
2-NN kernel, ``ops/cuda/vocab_knn.py``) and the NNDR matchers of the
visual odometry and registration (``match_nndr`` with its guess-projected
window, ``match_nndr_bidir``, ``cross_check``, ``match_mutual_nndr``),
the float-descriptor ``l2`` metric and the Grid Motion Statistics filter
``gms_filter``. For +-1 descriptors ``hamming = (D - a.b)/2`` and every
product here is exact in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.ops.features import DESC_DIM

# Full float32 products on the card: the +-1 dot products are exact only
# without TF32 (which would keep ~10 mantissa bits of each operand sum).
torch.backends.cuda.matmul.allow_tf32 = False

_NONE_KEY = 1 << 62       # (dist, idx) key of "no neighbour"
_IDX_BITS = 32


def similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (...,Ka,D) +-1 int8, b (...,Kb,D) +-1 int8 -> dot similarity
    (...,Ka,Kb) f32. Invalid (zeroed) descriptors give similarity 0 ==
    hamming D/2."""
    return a.float() @ b.float().transpose(-1, -2)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (DESC_DIM - similarity_matrix(a, b)) * 0.5


def knn_blocked(query: torch.Tensor, base: torch.Tensor, k: int,
                block: int = 8192, base_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of query (Q,D) against base (N,D), scanning the base in
    blocks. Returns (dists (Q,k) ascending, idx (Q,k) int32) in (dist, idx)
    lexicographic order — equal distances rank the lower index first. A
    missing neighbour (no valid base row left) reads dist 1e9, idx 0.

    Ties are exact: each candidate is ranked by the integer key
    ``2*dist << 32 | idx``, which ``topk`` orders without ambiguity."""
    Q, N = query.shape[0], base.shape[0]
    dev = query.device
    q = query.float()
    best = torch.full((Q, k), _NONE_KEY, dtype=torch.int64, device=dev)
    for start in range(0, N, block):
        blk = base[start:start + block]
        n = blk.shape[0]
        dist2 = (DESC_DIM - q @ blk.float().T).to(torch.int64)   # 2*hamming
        idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        key = (dist2 << _IDX_BITS) + idx
        if base_valid is not None:
            key = torch.where(base_valid[start:start + n], key, _NONE_KEY)
        best = torch.topk(torch.cat([best, key], dim=1), k, dim=1,
                          largest=False, sorted=True).values
    none = best == _NONE_KEY
    dists = torch.where(none, 1e9, (best >> _IDX_BITS).float() * 0.5)
    idx = torch.where(none, 0, best & ((1 << _IDX_BITS) - 1)).to(torch.int32)
    return dists.float(), idx


def l2_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distances of float descriptors (...,Ka,D) x (...,Kb,D)
    by one product, |a|^2 + |b|^2 - 2ab, clamped at 0 (the SIFT-family
    and SuperPoint metric)."""
    a, b = a.float(), b.float()
    sim = a @ b.transpose(-1, -2)
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    return torch.clamp(na[..., :, None] + nb[..., None, :] - 2.0 * sim, min=0.0)


def distance_matrix(a: torch.Tensor, b: torch.Tensor, metric: str = "hamming") -> torch.Tensor:
    return hamming_matrix(a, b) if metric == "hamming" else l2_matrix(a, b)


class Matches(NamedTuple):
    """Fixed-size match set from a's perspective."""

    idx: torch.Tensor      # (...,Ka) int32 index into b (best NN)
    dist: torch.Tensor     # (...,Ka) float32 best distance
    second: torch.Tensor   # (...,Ka) float32 second-best distance
    valid: torch.Tensor    # (...,Ka) bool passes NNDR + validity


_INF = 1e9


def _reduce_top2(d: torch.Tensor, valid_rows: torch.Tensor, nndr) -> Matches:
    """Best and second-best of each row of a masked distance matrix by two
    min/argmin passes. ``argmin`` returns the first minimum, so ties go to
    the lowest index as in the JAX twin; the second pass masks only the
    winner's column, so a tied runner-up reads the same distance."""
    best, idx = torch.min(d, dim=-1)
    second = torch.scatter(d, -1, idx[..., None], _INF).min(dim=-1).values
    ok = valid_rows & (best < _INF * 0.5) & (best <= nndr * second)
    return Matches(idx=idx.to(torch.int32), dist=best, second=second, valid=ok)


def match_nndr(desc_a, valid_a, desc_b, valid_b, nndr: float = 0.8,
               max_dist: Optional[float] = None, guess_uv: Optional[torch.Tensor] = None,
               uv_b: Optional[torch.Tensor] = None, window=0.0,
               metric: str = "hamming") -> Matches:
    """Nearest-neighbour + Lowe ratio matching a -> b, batched over leading
    dims. With ``guess_uv``/``uv_b`` the candidates outside the ``window``
    (pixels) around each row's guess are excluded in the same masked
    top-2 (the guess-projected window search)."""
    d = distance_matrix(desc_a, desc_b, metric)
    mask = valid_b[..., None, :]
    if guess_uv is not None and uv_b is not None:
        du = guess_uv[..., :, None, 0] - uv_b[..., None, :, 0]
        dv = guess_uv[..., :, None, 1] - uv_b[..., None, :, 1]
        mask = mask & ((du * du + dv * dv) <= window * window)
    m = _reduce_top2(torch.where(mask, d, _INF), valid_a, nndr)
    if max_dist is not None:
        m = m._replace(valid=m.valid & (m.dist <= max_dist))
    return m


def cross_check(m_ab: Matches, m_ba: Matches) -> torch.Tensor:
    """Mutual-consistency mask for a->b matches (batched over leading dims)."""
    idx = m_ab.idx.long()
    back = torch.gather(m_ba.idx, -1, idx)
    ids = torch.arange(idx.shape[-1], dtype=torch.int32, device=idx.device)
    return m_ab.valid & torch.gather(m_ba.valid, -1, idx) & (back == ids)


def match_nndr_bidir(desc_a, valid_a, desc_b, valid_b, nndr: float = 0.8,
                     metric: str = "hamming") -> Tuple[Matches, Matches]:
    """(m_ab, m_ba) from ONE distance matrix (batched over leading dims)."""
    d = distance_matrix(desc_a, desc_b, metric)
    m_ab = _reduce_top2(torch.where(valid_b[..., None, :], d, _INF), valid_a, nndr)
    dt = d.transpose(-1, -2)
    m_ba = _reduce_top2(torch.where(valid_a[..., None, :], dt, _INF), valid_b, nndr)
    return m_ab, m_ba


def match_mutual_nndr(desc_a, valid_a, desc_b, valid_b, nndr: float = 0.8) -> Matches:
    m_ab, m_ba = match_nndr_bidir(desc_a, valid_a, desc_b, valid_b, nndr)
    return m_ab._replace(valid=cross_check(m_ab, m_ba))


# ------------------------------------------------------------------------ GMS


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum over the last two axes, zero outside (the twin's SAME
    convolution with a ones kernel)."""
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    h, w = x.shape[-2:]
    return sum(p[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))


def gms_filter(uv_a, uv_b_matched, match_valid, shape_a, shape_b, grid: int = 8,
               threshold_factor: float = 6.0) -> torch.Tensor:
    """Grid-based Motion Statistics match verification (the reference's
    Vis/CorNNType 7, GMS/ThresholdFactor 6), batched over leading axes:
    uv_a (...,K,2) keypoints in A, uv_b_matched (...,K,2) their matched
    positions in B, match_valid (...,K), shapes (H, W). The matches are
    counted per (A cell, B cell) pair of a grid x grid grid on each image;
    a match survives when the 3x3 neighbourhood of its cell pair, over both
    grids, holds at least threshold_factor * sqrt(n_i) matches, n_i being
    the mean matches per A cell around its A cell. The counts and box sums
    are whole numbers, exact in float32 in any order of addition."""
    Ha, Wa = shape_a
    Hb, Wb = shape_b

    def cell(uv, H, W):
        return ((uv[..., 1] * grid / H).clamp(0, grid - 1).long() * grid
                + (uv[..., 0] * grid / W).clamp(0, grid - 1).long())

    ca, cb = cell(uv_a, Ha, Wa), cell(uv_b_matched, Hb, Wb)
    lead = match_valid.shape[:-1]
    G = grid * grid
    n_batch = int(np.prod(lead)) if lead else 1
    pair = torch.where(match_valid, ca * G + cb, G * G).reshape(n_batch, -1)
    pair = pair + torch.arange(n_batch, device=pair.device)[:, None] * (G * G + 1)
    counts = torch.zeros(n_batch * (G * G + 1), dtype=torch.float32, device=pair.device)
    counts.index_add_(0, pair.reshape(-1), torch.ones(pair.numel(), device=pair.device))
    counts = counts.reshape(n_batch, G * G + 1)[:, :G * G].reshape(n_batch, G, G)
    c4 = counts.reshape(n_batch, grid, grid, grid, grid)        # (ay, ax, by, bx)
    s = _box3(c4)                                                # over B cells
    s = _box3(s.permute(0, 3, 4, 1, 2)).permute(0, 3, 4, 1, 2)   # over A cells
    region = _box3(counts.sum(-1).reshape(n_batch, grid, grid)).reshape(n_batch, G)
    ai = ca.reshape(n_batch, -1).clamp(0, G - 1)
    bi = cb.reshape(n_batch, -1).clamp(0, G - 1)
    n_i = torch.gather(region, 1, ai) / 9.0
    thr = threshold_factor * torch.sqrt(torch.clamp(n_i, min=1e-6))
    support = torch.gather(s.reshape(n_batch, G * G), 1, ai * G + bi)
    return match_valid & (support >= thr).reshape(match_valid.shape)

"""Descriptor similarity and exact blocked k-NN for +-1 int8 descriptors.

Port of ``rtabmap_tpu/ops/matching.py``: ``similarity_matrix``,
``hamming_matrix``, ``knn_blocked`` (the plain version of the vocabulary
2-NN kernel, ``ops/cuda/vocab_knn.py``) and the NNDR matchers of the
visual odometry and registration (``match_nndr`` with its guess-projected
window, ``match_nndr_bidir``, ``cross_check``, ``match_mutual_nndr``).
For +-1 descriptors ``hamming = (D - a.b)/2`` and every product here is
exact in float32. The float-descriptor ``l2`` metric and ``gms_filter``
come with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def distance_matrix(a: torch.Tensor, b: torch.Tensor, metric: str = "hamming") -> torch.Tensor:
    if metric != "hamming":
        raise NotImplementedError(
            f"the {metric!r} metric (float descriptors, SIFT's) is not ported yet; it "
            "comes with the classical-front-end slice")
    return hamming_matrix(a, b)


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

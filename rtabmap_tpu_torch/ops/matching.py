"""Descriptor similarity and exact blocked k-NN for +-1 int8 descriptors.

Port of ``rtabmap_tpu/ops/matching.py`` (the parts the appearance-only
path reaches): ``similarity_matrix``, ``hamming_matrix`` and
``knn_blocked``, the plain version of the vocabulary 2-NN kernel
(``ops/cuda/vocab_knn.py``). For +-1 descriptors ``hamming = (D - a.b)/2``
and every product here is exact in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rtabmap_tpu_torch.ops.features import DESC_DIM

# Full float32 products on the card: the +-1 dot products are exact only
# without TF32 (which would keep ~10 mantissa bits of each operand sum).
torch.backends.cuda.matmul.allow_tf32 = False

_NONE_KEY = 1 << 62       # (dist, idx) key of "no neighbour"
_IDX_BITS = 32


def similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (Ka,D) +-1 int8, b (Kb,D) +-1 int8 -> dot similarity (Ka,Kb) f32.
    Invalid (zeroed) descriptors give similarity 0 == hamming D/2."""
    return a.float() @ b.float().T


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

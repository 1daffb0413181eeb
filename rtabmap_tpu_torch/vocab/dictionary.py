"""Incremental bag-of-visual-words vocabulary over a device descriptor slab.

Port of ``rtabmap_tpu/vocab/dictionary.py`` (single device):
``VWDictionary``, ``_quantize_kernel``, ``_insert_after_quantize``, the
tf-idf and similarity likelihoods and the Angeli adjustment. The 2-NN
search is the hand-written kernel ``ops/cuda/vocab_knn.knn2`` on the card
(its plain version on the CPU); quantization and new-word insertion run on
the device with no host round trip, and the host word counter catches up
from the returned ``n_new``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.ops.cuda.vocab_knn import knn2
from rtabmap_tpu_torch.ops.features import DESC_DIM


def _quantize_kernel(desc: torch.Tensor, valid: torch.Tensor, slab: torch.Tensor,
                     word_valid: torch.Tensor, nndr: torch.Tensor):
    """2-NN against the word slab + Lowe test. Returns (nn_idx (K,),
    is_new (K,)): is_new when the descriptor is not distinctive enough for
    its nearest word (dist0 > nndr * dist1), or when the vocabulary is
    empty."""
    d, i = knn2(desc, slab, word_valid)
    d0, d1 = d[:, 0], d[:, 1]
    # no valid second neighbour -> distinctive (match first) unless no words
    is_new = torch.where(d1 > 1e8, d0 > 1e8, d0 > nndr * d1)
    is_new = torch.where(word_valid.any(), is_new, True) & valid
    return i[:, 0], is_new


def _insert_after_quantize(nn_idx, is_new, desc, valid, slab, word_valid,
                           n_words: int, free: int, incremental: bool = True):
    """New-word slot assignment + insertion on the device. Updates ``slab``
    and ``word_valid`` IN PLACE (the JAX version returns new arrays). Both
    carry one spare row past the capacity: descriptors that get no slot
    are written there — the JAX scatter's ``mode="drop"`` — so the
    scatter needs no host sync to mask them.

    Returns (word_ids (K,) int32 with -1 for invalid, keep (K,) bool,
    n_new () int32)."""
    if not incremental:
        word_ids = torch.where(valid & ~is_new, nn_idx, -1).to(torch.int32)
        return word_ids, torch.zeros_like(is_new), torch.zeros((), dtype=torch.int32,
                                                               device=desc.device)
    order = torch.cumsum(is_new.to(torch.int32), 0)
    keep = is_new & (order <= free)
    slots = (n_words + torch.cumsum(keep.to(torch.int32), 0) - 1).to(torch.int32)
    spare = slab.shape[0] - 1
    safe = torch.where(keep, slots, spare).long()
    slab.index_copy_(0, safe, desc)
    word_valid.index_fill_(0, safe, True)
    word_ids = torch.where(valid, torch.where(keep, slots, nn_idx), -1).to(torch.int32)
    return word_ids, keep, keep.sum(dtype=torch.int32)


class VWDictionary:
    """Host-managed vocabulary over a device descriptor slab."""

    def __init__(self, capacity: int = 131072, desc_dim: int = DESC_DIM,
                 nndr: float = 0.8, incremental: bool = True,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.desc_dim = desc_dim
        self.nndr = float(nndr)
        self.incremental = incremental
        # one spare row past the capacity absorbs dropped inserts
        self._slab = torch.zeros((capacity + 1, desc_dim), dtype=torch.int8,
                                 device=self.device)
        self._word_valid = torch.zeros((capacity + 1,), dtype=torch.bool,
                                       device=self.device)
        self._nndr_t = torch.tensor(self.nndr, dtype=torch.float32, device=self.device)
        self.n_words = 0
        self._uncommitted = False

    @property
    def slab(self) -> torch.Tensor:
        return self._slab[: self.capacity]

    @property
    def word_valid(self) -> torch.Tensor:
        return self._word_valid[: self.capacity]

    def quantize(self, desc, valid) -> Tuple[np.ndarray, np.ndarray]:
        """Assign word ids to descriptors; create new words in incremental
        mode. Returns host (word_ids (K,) int32, -1 invalid; is_new (K,))."""
        wid, new, n_new = self.quantize_async(desc, valid)
        self.commit_new_words(int(n_new))
        return wid.cpu().numpy(), new.cpu().numpy()

    def quantize_async(self, desc, valid):
        """Device-only quantization + insertion. Returns device (word_ids,
        is_new, n_new); the caller passes the fetched n_new to
        ``commit_new_words`` before the next quantize call.

        Words are only appended and never cleared, so the valid words are
        the prefix ``[0, n_words)`` of the slab, and the 2-NN scans that
        prefix only (at least one row: an empty vocabulary reads as one
        invalid word). That needs ``n_words`` current, hence the check."""
        if self._uncommitted:
            raise RuntimeError("commit_new_words must follow each quantize_async")
        n = max(self.n_words, 1)
        nn_idx, is_new = _quantize_kernel(desc, valid, self._slab[:n],
                                          self._word_valid[:n], self._nndr_t)
        self._uncommitted = True
        return _insert_after_quantize(
            nn_idx, is_new, desc, valid, self._slab, self._word_valid,
            self.n_words, self.capacity - self.n_words,
            incremental=self.incremental)

    def commit_new_words(self, n_new: int):
        self.n_words += int(n_new)
        self._uncommitted = False

    def descriptors(self, word_ids):
        return self.slab[torch.as_tensor(word_ids, device=self.device).long()]

    def state_dict(self):
        return {
            "slab": self.slab.cpu().numpy(),
            "word_valid": self.word_valid.cpu().numpy(),
            "n_words": self.n_words,
            "nndr": self.nndr,
            "incremental": self.incremental,
        }

    @classmethod
    def from_state(cls, st, device: DeviceLike = None) -> "VWDictionary":
        """From a ``state_dict()`` of either package (numpy arrays). Raises
        on a valid word past ``n_words``: quantization scans the prefix."""
        slab = np.asarray(st["slab"])
        if np.asarray(st["word_valid"], bool)[int(st["n_words"]):].any():
            raise ValueError("word_valid holds a valid word past n_words")
        d = cls(capacity=slab.shape[0], desc_dim=slab.shape[1], nndr=st["nndr"],
                incremental=st["incremental"], device=device)
        d.slab.copy_(torch.from_numpy(slab.astype(np.int8)))
        d.word_valid.copy_(torch.from_numpy(np.array(st["word_valid"], bool)))
        d.n_words = int(st["n_words"])
        return d


# --------------------------------------------------------------- likelihoods


def tfidf_likelihood(query_words, node_words, node_valid, word_nw, n_places,
                     vocab_cap: int) -> torch.Tensor:
    """tf-idf likelihood of the query frame against all resident nodes
    (reference: Memory::computeLikelihood): for each unique query word w,
    every node containing w gains log10(N/nw) per occurrence, divided by
    the node's word count.

    Computed as a gather from a (W+1,) weight table indexed by the node
    word lists — the same sum as the JAX version's (N,K,Kq) compare-reduce
    (each node word matches at most one unique query word), without the
    (N,K,Kq) intermediate. query_words (K,) int32 (-1 invalid);
    node_words (N,K) int32 (-1 pad); word_nw (W,) f32; n_places scalar."""
    W = vocab_cap
    nw = torch.clamp(word_nw, min=0.0)
    n_places = torch.as_tensor(n_places, dtype=torch.float32, device=nw.device)
    log_w = torch.where(nw > 0, torch.log10(torch.clamp(n_places, min=1.0)
                                            / torch.clamp(nw, min=1.0)),
                        torch.zeros_like(nw))
    table = torch.zeros((W + 1,), dtype=torch.float32, device=nw.device)
    qw = torch.where(query_words >= 0, query_words, W).long()
    table[qw] = torch.cat([log_w, log_w.new_zeros(1)])[qw]   # duplicates agree
    has = node_words >= 0
    contrib = table[torch.where(has, node_words, W).long()]
    ni = has.sum(-1)
    lik = contrib.sum(-1) / torch.clamp(ni, min=1)
    return torch.where(node_valid & (ni > 0), lik, torch.zeros_like(lik))


def similarity_likelihood(query_words, node_words, node_valid) -> torch.Tensor:
    """Non-tf-idf likelihood (reference: Kp/TfIdfLikelihoodUsed=false ->
    Signature::compareTo): shared unique words / max(unique word counts)."""
    big = 2 ** 30
    qs = torch.sort(torch.where(query_words >= 0, query_words, big)).values
    quniq = torch.cat([torch.ones(1, dtype=torch.bool, device=qs.device),
                       qs[1:] != qs[:-1]]) & (qs < big)
    ns = torch.sort(torch.where(node_words >= 0, node_words, big), dim=-1).values
    nuniq = torch.cat([torch.ones((ns.shape[0], 1), dtype=torch.bool, device=ns.device),
                       ns[:, 1:] != ns[:, :-1]], dim=1) & (ns < big)
    # membership of each unique node word in the unique query words
    pos = torch.searchsorted(qs, ns).clamp(max=qs.shape[0] - 1)
    in_q = (qs[pos] == ns) & quniq[pos]
    shared = (in_q & nuniq).sum(-1)
    nq = quniq.sum()
    nn = nuniq.sum(-1)
    sim = shared / torch.clamp(torch.maximum(nq, nn), min=1)
    return torch.where(node_valid & (nn > 0), sim.float(), torch.zeros_like(sim, dtype=torch.float32))


def adjust_likelihood(lik, node_valid):
    """Angeli mean/stddev normalization + virtual-place score (reference:
    Rtabmap::adjustLikelihood). Returns (adjusted (N,), virtual ())."""
    eps = 1e-4
    mask = node_valid & (lik > 0)
    zero = torch.zeros_like(lik)
    n = torch.clamp(mask.sum(), min=1)
    mean = torch.where(mask, lik, zero).sum() / n
    var = torch.where(mask, (lik - mean) ** 2, zero).sum() / torch.clamp(n - 1, min=1)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    max_v = torch.where(mask, lik, zero).max()
    adjusted = torch.where(mask & (lik > mean + std) & (mean > 0),
                           (lik - (std - eps)) / torch.clamp(mean, min=1e-12),
                           torch.ones_like(lik))
    adjusted = torch.where(node_valid, adjusted, zero)
    virtual = torch.where((std > eps) & (max_v > 0),
                          mean / torch.clamp(std, min=1e-12) + 1.0,
                          torch.full_like(mean, 2.0))
    return adjusted, virtual

"""Discrete Bayesian place-recognition filter over the working memory.

Port of ``rtabmap_tpu/bayes/filter.py``: the recursive posterior with the
graph-neighbourhood prediction (reference BayesFilter::computePosterior,
generatePrediction) as a scatter over a fixed-capacity neighbour table,
the host neighbour tables, and the dense prediction matrix for dumps.
Posterior slots align with the engine's node slab; slot N is the virtual
place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_PREDICTION_LC = np.array(
    [0.1, 0.36, 0.30, 0.16, 0.062, 0.0151, 0.00255, 0.000324, 2.5e-05,
     1.3e-06, 4.8e-08, 1.2e-09, 1.9e-11, 2.2e-13, 1.7e-15, 8.5e-18,
     2.9e-20, 6.9e-23],
    np.float32,
)  # [virtual place, margin 0 (loop), margin 1, ..., margin 16]


class BayesState(NamedTuple):
    posterior: torch.Tensor  # (N+1,) — slot N = virtual place


def init_state(capacity: int, device=None) -> BayesState:
    p = torch.zeros((capacity + 1,), dtype=torch.float32, device=device)
    p[capacity] = 1.0
    return BayesState(posterior=p)


def _margin_weight(kernel, margin):
    """Graph distance m -> prediction mass. Kernel layout (reference
    Bayes/PredictionLC): [vp, lc, b1, f1, b2, f2, ...]; distance m takes
    the mean of the pair (kernel[2m], kernel[2m+1]) since the neighbour
    table is direction-less. Works on tensors and on numpy arrays."""
    xp = torch if isinstance(margin, torch.Tensor) else np
    K = kernel.shape[0]
    idx = xp.clip(2 * margin, 0, K - 1)
    idx2 = xp.clip(2 * margin + 1, 0, K - 1)
    pair = 0.5 * (kernel[idx] + kernel[idx2])
    # beyond the kernel's reach the mass is zero, not the clipped tail
    zero = torch.zeros_like(pair) if xp is torch else 0.0
    pair = xp.where(2 * margin <= K - 1, pair, zero)
    return xp.where(margin == 0, kernel[1], pair)


def _predict_and_update(posterior, likelihood, virtual_score, nbr_idx, nbr_margin,
                        node_valid, kernel, vp_prior):
    """One Bayes recursion. posterior (N+1,), likelihood (N,), nbr_idx /
    nbr_margin (N,Kn) int (idx -1 = invalid), kernel (18,), vp_prior
    scalar. The prediction scatter is ``index_add_`` at every N; on the
    card its float atomics sum in a varying order."""
    N = likelihood.shape[0]
    dev = likelihood.device
    vp = kernel[0]
    total_lc = kernel.sum()
    nbr_idx = nbr_idx.long()
    w = torch.where(nbr_idx >= 0, _margin_weight(kernel, nbr_margin.long()),
                    torch.zeros((), dtype=torch.float32, device=dev))
    sum_w = w.sum(-1)
    # unassigned neighbour mass goes to the source itself (reference
    # normalize(): delta added to the diagonal)
    self_extra = torch.clamp((total_lc - vp) - sum_w, min=0.0)
    col_sum = sum_w + self_extra
    scale = torch.where(col_sum > 0, (1.0 - vp) / col_sum, torch.zeros_like(col_sum))
    valid_f = node_valid.float()
    post_real = posterior[:N] * valid_f
    contrib = post_real[:, None] * w * scale[:, None]
    tgt = torch.where(nbr_idx >= 0, nbr_idx, N)
    prior = torch.zeros((N + 1,), dtype=torch.float32, device=dev)
    prior.index_add_(0, tgt.reshape(-1), contrib.reshape(-1))
    prior[:N] += post_real * self_extra * scale
    # virtual-place column: P[virtual,virtual]=vp_prior, rest uniform
    post_v = posterior[N]
    n_valid = torch.clamp(node_valid.sum(), min=1)
    prior[:N] += post_v * (1.0 - vp_prior) / n_valid * valid_f
    # every real column contributes kernel[0] to the virtual place
    prior[N] += vp * post_real.sum() + vp_prior * post_v
    lik_full = torch.cat([torch.where(node_valid, likelihood, torch.zeros_like(likelihood)),
                          virtual_score.reshape(1)])
    post = prior * lik_full
    s = post.sum()
    fallback = torch.zeros_like(post)
    fallback[N] = 1.0
    return torch.where(s > 0, post / s, fallback)


class BayesFilter:
    """Host wrapper holding the kernel + posterior on ``device``; neighbour
    tables come from the caller (the engine's graph bookkeeping)."""

    def __init__(self, capacity: int, prediction_lc=None,
                 virtual_place_prior: float = 0.9, device=None):
        kernel = np.array(prediction_lc if prediction_lc is not None
                          else DEFAULT_PREDICTION_LC, np.float32)
        self.device = device
        self.kernel = torch.from_numpy(kernel).to(device)
        self.vp_prior = torch.tensor(virtual_place_prior, dtype=torch.float32,
                                     device=device)
        self.capacity = capacity
        self.state = init_state(capacity, device)

    def reset(self):
        self.state = init_state(self.capacity, self.device)

    def update(self, likelihood, virtual_score, nbr_idx, nbr_margin, node_valid):
        post = _predict_and_update(
            self.state.posterior, likelihood,
            torch.as_tensor(virtual_score, dtype=torch.float32, device=self.device),
            nbr_idx, nbr_margin, node_valid, self.kernel, self.vp_prior)
        self.state = BayesState(posterior=post)
        return post

    @property
    def posterior(self):
        return self.state.posterior


class IncrementalNeighborTable:
    """Incrementally-maintained BFS neighbor table over the resident WM
    graph — the per-tick replacement for rebuilding ``build_neighbor_table``
    from scratch (the reference's BayesFilter caches prediction rows the
    same way: only neighborhoods touched by graph changes are refreshed,
    BayesFilter.cpp:330 getNeighborsId + prediction cache).

    A link add/remove only changes the BFS rows of slots within ``depth``
    hops of its endpoints; a node insert/remove likewise. Amortized cost
    per tick is O(depth-neighborhood), not O(N)."""

    def __init__(self, n_slots: int, depth: int, max_neighbors: int):
        self.n_slots = n_slots
        self.depth = depth
        self.max_neighbors = max_neighbors
        self.adj = [set() for _ in range(n_slots)]
        self.nbr_idx = np.full((n_slots, max_neighbors), -1, np.int32)
        self.nbr_margin = np.zeros((n_slots, max_neighbors), np.int32)
        self._dirty: set = set()

    def _mark_around(self, seeds):
        seen = set(s for s in seeds if 0 <= s < self.n_slots)
        frontier = list(seen)
        for _ in range(self.depth):
            nxt = []
            for u in frontier:
                for v in self.adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        self._dirty |= seen

    def add_node(self, slot: int):
        if 0 <= slot < self.n_slots:
            self.adj[slot].clear()
            self._dirty.add(slot)

    def remove_node(self, slot: int):
        if not (0 <= slot < self.n_slots):
            return
        self._mark_around([slot])
        for v in self.adj[slot]:
            self.adj[v].discard(slot)
        self.adj[slot].clear()
        self.nbr_idx[slot] = -1
        self.nbr_margin[slot] = 0
        self._dirty.discard(slot)

    def add_edge(self, a: int, b: int):
        if 0 <= a < self.n_slots and 0 <= b < self.n_slots and a != b:
            self.adj[a].add(b)
            self.adj[b].add(a)
            self._mark_around([a, b])

    def remove_edge(self, a: int, b: int):
        if 0 <= a < self.n_slots and 0 <= b < self.n_slots:
            self._mark_around([a, b])
            self.adj[a].discard(b)
            self.adj[b].discard(a)

    def flush(self):
        """Recompute BFS rows for dirty slots; returns the arrays."""
        for s in self._dirty:
            seen = {s: 0}
            frontier = [s]
            for m in range(1, self.depth + 1):
                nxt = []
                for u in frontier:
                    for v in self.adj[u]:
                        if v not in seen:
                            seen[v] = m
                            nxt.append(v)
                frontier = nxt
                if not frontier:
                    break
            items = sorted(seen.items(),
                           key=lambda kv: (kv[1], kv[0]))[: self.max_neighbors]
            self.nbr_idx[s] = -1
            self.nbr_margin[s] = 0
            for k, (v, m) in enumerate(items):
                self.nbr_idx[s, k] = v
                self.nbr_margin[s, k] = m
        self._dirty.clear()
        return self.nbr_idx, self.nbr_margin


def build_neighbor_table(links, n_slots: int, depth: int, max_neighbors: int):
    """Host-side BFS over undirected links -> (nbr_idx, nbr_margin) arrays.

    ``links``: iterable of (slot_a, slot_b). Each node's table contains
    itself at margin 0 plus neighbors up to ``depth`` hops (the reference's
    getNeighborsId over neighbor links, BayesFilter.cpp:330).
    """
    adj = [[] for _ in range(n_slots)]
    for a, b in links:
        if 0 <= a < n_slots and 0 <= b < n_slots and a != b:
            adj[a].append(b)
            adj[b].append(a)
    nbr_idx = np.full((n_slots, max_neighbors), -1, np.int32)
    nbr_margin = np.zeros((n_slots, max_neighbors), np.int32)
    for s in range(n_slots):
        seen = {s: 0}
        frontier = [s]
        for m in range(1, depth + 1):
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in seen:
                        seen[v] = m
                        nxt.append(v)
            frontier = nxt
            if not frontier:
                break
        items = sorted(seen.items(), key=lambda kv: (kv[1], kv[0]))[:max_neighbors]
        for k, (v, m) in enumerate(items):
            nbr_idx[s, k] = v
            nbr_margin[s, k] = m
    return nbr_idx, nbr_margin


def prediction_matrix(nbr_idx, nbr_margin, node_valid, kernel,
                      vp_prior: float = 0.9) -> np.ndarray:
    """Dense (N+1,N+1) column-stochastic prediction matrix — the explicit
    form of the sparse prediction inside `_predict_and_update`
    (reference: BayesFilter::generatePrediction, dumped by
    Rtabmap::dumpPrediction)."""
    nbr_idx = np.asarray(nbr_idx)
    nbr_margin = np.asarray(nbr_margin)
    node_valid = np.asarray(node_valid, bool)
    kernel = np.asarray(kernel, np.float64)
    N = nbr_idx.shape[0]
    vp = kernel[0]
    total_lc = kernel.sum()
    P = np.zeros((N + 1, N + 1))
    for src in range(N):
        if not node_valid[src]:
            continue
        w = np.where(nbr_idx[src] >= 0,
                     _margin_weight(kernel, nbr_margin[src]), 0.0)
        self_extra = max((total_lc - vp) - w.sum(), 0.0)
        col = w.sum() + self_extra
        scale = (1.0 - vp) / col if col > 0 else 0.0
        for k in range(nbr_idx.shape[1]):
            if nbr_idx[src, k] >= 0:
                P[nbr_idx[src, k], src] += w[k] * scale
        P[src, src] += self_extra * scale
        P[N, src] = vp
    n_valid = max(int(node_valid.sum()), 1)
    P[:N, N] = np.where(node_valid, (1.0 - vp_prior) / n_valid, 0.0)
    P[N, N] = vp_prior
    return P

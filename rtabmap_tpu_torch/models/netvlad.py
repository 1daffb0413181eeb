"""NetVLAD-style global descriptors and a matmul retrieval index.

Port of ``rtabmap_tpu/models/netvlad.py`` (the reference's
``GlobalDescriptorExtractor`` role): VLAD aggregation of a frame's local
descriptors (soft or hard assignment, intra-normalization, global L2), a
masked k-means codebook, and a fixed-capacity cosine index. The twin draws
k-means' initial centres with ``jax.random.choice``; here they are injected
(``init_idx``) or drawn from a torch generator.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device


def kmeans_codebook(desc: torch.Tensor, valid: torch.Tensor,
                    generator: Optional[torch.Generator] = None, n_clusters: int = 64,
                    iters: int = 10, init_idx=None) -> torch.Tensor:
    """Fit a (C, D) codebook by masked Lloyd iterations; desc (N, D) float,
    invalid rows excluded. The initial centres are rows ``init_idx`` (C,) or,
    without it, C distinct valid rows drawn from ``generator``."""
    x = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    if init_idx is None:
        w = valid.float().cpu()
        init_idx = torch.multinomial(w / torch.clamp(w.sum(), min=1.0), n_clusters,
                                     replacement=False, generator=generator)
    centers = desc[torch.as_tensor(init_idx, device=desc.device).long()]
    vmask = valid[:, None].to(desc.dtype)
    for _ in range(iters):
        d2 = (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * x @ centers.T
              + torch.sum(centers * centers, dim=1)[None])
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), n_clusters).to(
            desc.dtype) * vmask
        sums = onehot.T @ x
        cnts = torch.sum(onehot, dim=0)
        centers = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts[:, None], min=1),
                              centers)
    return centers


def vlad(desc: torch.Tensor, valid: torch.Tensor, codebook: torch.Tensor,
         alpha: float = 10.0, soft: bool = True) -> torch.Tensor:
    """VLAD aggregation -> L2-normalized (C*D,) global descriptor: soft
    (NetVLAD) or hard assignment, per-cluster then global normalization."""
    C, D = codebook.shape
    x = desc.float()
    d2 = (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * x @ codebook.T
          + torch.sum(codebook * codebook, dim=1)[None])
    if soft:
        a = torch.softmax(-alpha * d2, dim=1)
    else:
        a = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), C).float()
    a = a * valid[:, None]
    resid = x[:, None, :] - codebook[None, :, :]
    v = torch.einsum("kc,kcd->cd", a, resid)
    v = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-12)
    v = v.reshape(-1)
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


class NetVLAD:
    """Codebook management and per-frame extraction on ``device`` (None =
    the CUDA card)."""

    def __init__(self, codebook=None, n_clusters: int = 64, alpha: float = 10.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.codebook = None if codebook is None else self._t(codebook)
        self.n_clusters = n_clusters
        self.alpha = alpha

    def _t(self, x, dtype=torch.float32):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.array(x)).to(device=self.device, dtype=dtype)

    def fit(self, desc, valid, seed: int = 0, init_idx=None):
        self.codebook = kmeans_codebook(
            self._t(desc), self._t(valid, torch.bool), torch.Generator().manual_seed(seed),
            n_clusters=self.n_clusters, init_idx=init_idx)
        return self

    def extract(self, desc, valid) -> torch.Tensor:
        if self.codebook is None:
            raise RuntimeError("fit() or pass a codebook first")
        return vlad(self._t(desc), self._t(valid, torch.bool), self.codebook, alpha=self.alpha)

    @property
    def dim(self) -> int:
        return 0 if self.codebook is None else int(np.prod(self.codebook.shape))


class GlobalDescriptorIndex:
    """Fixed-capacity retrieval slab: per-node global descriptors, cosine
    top-k of a query in one product (the loop-closure shortlist the
    reference builds from NetVLAD descriptors)."""

    def __init__(self, dim: int, capacity: int = 4096, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.slab = torch.zeros((capacity, dim), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.ids = np.full((capacity,), -1, np.int64)
        self.cursor = 0

    def add(self, node_id: int, g):
        slot = self.cursor % self.slab.shape[0]
        self.slab[slot] = torch.as_tensor(np.asarray(g, np.float32) if not isinstance(
            g, torch.Tensor) else g, device=self.device)
        self.valid[slot] = True
        self.ids[slot] = node_id
        self.cursor += 1

    def query(self, g, k: int = 5, exclude_ids=()) -> Tuple[np.ndarray, np.ndarray]:
        """-> (node_ids (k,), cosine scores (k,)); unfilled slots are -1."""
        q = g.to(self.device) if isinstance(g, torch.Tensor) else \
            torch.from_numpy(np.asarray(g, np.float32)).to(self.device)
        sims = self.slab @ q
        scores = torch.where(self.valid, sims, torch.full_like(sims, -2.0)).cpu().numpy()
        for e in exclude_ids:
            scores[self.ids == e] = -2.0
        order = np.argsort(-scores)[:k]
        return self.ids[order], scores[order]

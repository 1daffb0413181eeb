"""Attentional feature matcher (SuperGlue-class): the bundled matcher of
``Vis/CorNNType`` 6.

Port of ``rtabmap_tpu/models/superglue.py`` (the reference's PyMatcher
slot): a keypoint encoder (an MLP on normalized uv and score) added to the
projected descriptors, L alternating self- and cross-attention blocks, a
final projection, and the dustbin-augmented log-domain Sinkhorn. The
attention follows flax's ``MultiHeadDotProductAttention``: query, key and
value kernels laid out (dim, heads, head_dim), the query scaled by
1/sqrt(head_dim) before the product, masked logits set to the float32
minimum (a row with every key masked gets uniform weights, not NaN).
Weights load from the twin's npz layout (``params/...``) through
``params_from_flax``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from rtabmap_tpu_torch.device import DeviceLike, resolve_device

WEIGHTS = os.path.join(os.path.dirname(__file__), "weights", "superglue_distilled.npz")
_NEG = torch.finfo(torch.float32).min


class Dense(nn.Module):
    """flax ``Dense``: y = x @ kernel + bias, kernel (in, out)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, x):
        return x @ self.kernel + self.bias


class KeypointEncoder(nn.Module):
    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList(Dense(i, o) for i, o in ((3, 32), (32, 64), (64, dim)))

    def forward(self, uv_norm, score):
        x = torch.cat([uv_norm, score[..., None]], dim=-1)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class MultiHeadDotProductAttention(nn.Module):
    """flax's multi-head attention with ``qkv_features`` = dim."""

    def __init__(self, dim: int = 128, heads: int = 4):
        super().__init__()
        hd = dim // heads
        self.heads, self.head_dim = heads, hd
        for name in ("query", "key", "value"):
            self.register_parameter(f"{name}_kernel", nn.Parameter(
                torch.randn(dim, heads, hd) / np.sqrt(dim)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(heads, hd)))
        self.out_kernel = nn.Parameter(torch.randn(heads, hd, dim) / np.sqrt(dim))
        self.out_bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, source, mask_src):
        q = torch.einsum("qd,dhk->qhk", x, self.query_kernel) + self.query_bias
        k = torch.einsum("sd,dhk->shk", source, self.key_kernel) + self.key_bias
        v = torch.einsum("sd,dhk->shk", source, self.value_kernel) + self.value_bias
        q = q / np.float32(np.sqrt(self.head_dim))
        w = torch.einsum("qhd,khd->hqk", q, k)
        w = torch.where(mask_src[None, None, :], w, torch.full_like(w, _NEG))
        w = torch.softmax(w, dim=-1)
        out = torch.einsum("hqk,khd->qhd", w, v)
        return torch.einsum("qhd,hdo->qo", out, self.out_kernel) + self.out_bias


class AttentionBlock(nn.Module):
    def __init__(self, dim: int = 128, heads: int = 4):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(dim, heads)
        self.mlp0 = Dense(2 * dim, 2 * dim)
        self.mlp1 = Dense(2 * dim, dim)

    def forward(self, x, source, mask_src):
        """Residual MHA + MLP; ``source`` is x for self-attention, the other
        image's features for cross-attention."""
        att = self.attn(x, source, mask_src)
        y = torch.relu(self.mlp0(torch.cat([x, att], dim=-1)))
        return x + self.mlp1(y)


class SuperGlueNet(nn.Module):
    def __init__(self, dim: int = 128, layers: int = 4, desc_dim: int = 256):
        super().__init__()
        self.dim = dim
        self.proj = Dense(desc_dim, dim)
        self.enc = KeypointEncoder(dim)
        self.self_blocks = nn.ModuleList(AttentionBlock(dim) for _ in range(layers))
        self.cross_blocks = nn.ModuleList(AttentionBlock(dim) for _ in range(layers))
        self.fin = Dense(dim, dim)
        self.dustbin = nn.Parameter(torch.ones(()))

    def forward(self, desc_a, uv_a, sc_a, va, desc_b, uv_b, sc_b, vb):
        xa = self.proj(desc_a) + self.enc(uv_a, sc_a)
        xb = self.proj(desc_b) + self.enc(uv_b, sc_b)
        for blk_self, blk_cross in zip(self.self_blocks, self.cross_blocks):
            xa = blk_self(xa, xa, va)
            xb = blk_self(xb, xb, vb)
            xa, xb = blk_cross(xa, xb, vb), blk_cross(xb, xa, va)
        xa, xb = self.fin(xa), self.fin(xb)
        scores = (xa @ xb.T) / np.float32(np.sqrt(self.dim))
        return scores, self.dustbin


def log_sinkhorn(scores, dustbin, va, vb, iters: int = 30):
    """Log-domain Sinkhorn over the (Ka+1, Kb+1) score matrix with a dustbin
    row and column (SuperGlue's partial assignment); invalid keypoints
    route to the dustbin. Returns the log transport."""
    Ka, Kb = scores.shape
    neg = torch.full((), -1e9, dtype=scores.dtype, device=scores.device)
    dustbin = dustbin.to(scores.dtype)
    s = torch.where(va[:, None] & vb[None, :], scores, neg)
    s = torch.cat([s, torch.where(va, dustbin, neg)[:, None]], dim=1)
    bot = torch.cat([torch.where(vb, dustbin, neg), dustbin[None]])
    s = torch.cat([s, bot[None, :]], dim=0)
    na = torch.clamp(va.sum().float(), min=1.0)
    nb = torch.clamp(vb.sum().float(), min=1.0)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    log_mu = torch.cat([torch.where(va, zero, neg), torch.log(nb)[None]])
    log_nu = torch.cat([torch.where(vb, zero, neg), torch.log(na)[None]])
    u = torch.zeros(Ka + 1, dtype=scores.dtype, device=scores.device)
    v = torch.zeros(Kb + 1, dtype=scores.dtype, device=scores.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(s + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(s + u[:, None], dim=0)
    return s + u[:, None] + v[None, :]


def _flax_names(layers: int):
    """(twin key, port key) of every parameter: ``params/Dense_0`` the
    projection, ``params/Dense_1`` the final layer, ``KeypointEncoder_0``,
    ``self_i`` / ``cross_i`` with ``MultiHeadDotProductAttention_0`` and
    their MLP's ``Dense_0`` / ``Dense_1``, and ``dustbin``."""
    pairs = [("params/Dense_0/kernel", "proj.kernel"), ("params/Dense_0/bias", "proj.bias"),
             ("params/Dense_1/kernel", "fin.kernel"), ("params/Dense_1/bias", "fin.bias"),
             ("params/dustbin", "dustbin")]
    for j in range(3):
        for leaf in ("kernel", "bias"):
            pairs.append((f"params/KeypointEncoder_0/Dense_{j}/{leaf}", f"enc.layers.{j}.{leaf}"))
    for kind in ("self", "cross"):
        for i in range(layers):
            src, dst = f"params/{kind}_{i}", f"{kind}_blocks.{i}"
            for leaf in ("kernel", "bias"):
                pairs.append((f"{src}/Dense_0/{leaf}", f"{dst}.mlp0.{leaf}"))
                pairs.append((f"{src}/Dense_1/{leaf}", f"{dst}.mlp1.{leaf}"))
                for name in ("query", "key", "value", "out"):
                    pairs.append((f"{src}/MultiHeadDotProductAttention_0/{name}/{leaf}",
                                  f"{dst}.attn.{name}_{leaf}"))
    return pairs


def params_from_flax(flat: Dict[str, np.ndarray], layers: int = 4) -> Dict[str, torch.Tensor]:
    """The twin's parameter tree flattened with "/" (its npz keys,
    ``params/...``) -> a ``SuperGlueNet`` state dict (float32)."""
    return {dst: torch.from_numpy(np.array(flat[src], np.float32))
            for src, dst in _flax_names(layers)}


class SuperGlueMatcher:
    """Owns the network on ``device`` (None = the CUDA card); ``match`` gives
    the Matches-compatible output. ``calls`` counts the matches run."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None, dim: int = 128,
                 layers: int = 4, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim, self.layers = dim, layers
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)   # seeded random weights when params is None
            self.net = SuperGlueNet(dim=dim, layers=layers)
        if params is not None:
            self.net.load_state_dict(params)
        self.net.to(self.device).eval()
        self.calls = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def _t(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.array(x)).to(device=self.device, dtype=dtype)

    def match(self, desc_a, uv_a, score_a, valid_a, desc_b, uv_b, score_b, valid_b,
              image_wh=(640.0, 480.0), threshold: float = 0.2):
        """-> (idx (Ka,) int32, valid (Ka,), confidence (Ka,)): the mutual
        best of the Sinkhorn transport above ``threshold``."""
        self.calls += 1
        f32, b = torch.float32, torch.bool
        return _match(self.net, self._t(desc_a, f32), self._t(uv_a, f32), self._t(score_a, f32),
                      self._t(valid_a, b), self._t(desc_b, f32), self._t(uv_b, f32),
                      self._t(score_b, f32), self._t(valid_b, b),
                      float(image_wh[0]), float(image_wh[1]), threshold)

    def save_params(self, path: str):
        """The twin's npz layout (``params/...``)."""
        state = self.params
        np.savez(path, **{src: state[dst].detach().cpu().float().numpy()
                          for src, dst in _flax_names(self.layers)})

    @classmethod
    def distilled(cls, device: DeviceLike = None) -> "SuperGlueMatcher":
        """The bundled trained weights (``weights/superglue_distilled.npz``, a
        byte-identical copy of the JAX package's); a missing file raises."""
        if not os.path.exists(WEIGHTS):
            raise FileNotFoundError(f"{WEIGHTS} missing")
        return cls.load_params(WEIGHTS, device=device)

    @classmethod
    def load_params(cls, path: str, dim: int = 128, layers: int = 4,
                    device: DeviceLike = None) -> "SuperGlueMatcher":
        with np.load(path) as raw:
            flat = {k: raw[k] for k in raw.files}
        return cls(params=params_from_flax(flat, layers), dim=dim, layers=layers, device=device)


@torch.no_grad()
def _match(net, desc_a, uv_a, sc_a, va, desc_b, uv_b, sc_b, vb, w: float, h: float,
           threshold: float):
    s = torch.tensor([w, h], dtype=torch.float32, device=uv_a.device)
    na = (uv_a / s) * 2.0 - 1.0
    nb = (uv_b / s) * 2.0 - 1.0
    scores, dustbin = net(desc_a, na, sc_a, va, desc_b, nb, sc_b, vb)
    logp = log_sinkhorn(scores, dustbin, va, vb)
    p = torch.exp(logp[:-1, :-1])
    idx = torch.argmax(p, dim=1)
    conf = torch.max(p, dim=1).values
    back = torch.argmax(p, dim=0)
    mutual = back[idx] == torch.arange(p.shape[0], device=p.device)
    ok = va & mutual & (conf > threshold) & vb[idx]
    return idx.to(torch.int32), ok, conf

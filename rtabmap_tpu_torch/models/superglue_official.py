"""Official-architecture SuperGlue (the indoor/outdoor pretrained layout) as
functions on a parameter dict.

Port of ``rtabmap_tpu/models/superglue_official.py`` (the reference's
``rtabmap_superglue.py`` graph): the keypoint MLP encoder with BatchNorm in
eval mode, 18 alternating self/cross attentional-propagation layers (4
heads, 256 wide), the final projection and the dustbin log-Sinkhorn.
Parameters come from ``models/convert.convert_superglue`` or
``load_params`` (the twin's npz layout, nested dicts and lists flattened
with "/"); ``save_params`` writes that layout.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device

HIDDEN = 256
HEADS = 4
BN_EPS = 1e-5
# official indoor/outdoor checkpoints: 9 (self, cross) pairs
LAYER_TYPES = ("self", "cross") * 9


def _linear(p, x):
    return x @ p["w"].T + p["b"]


def _bn_eval(p, x):
    return (x - p["mean"]) / torch.sqrt(p["var"] + BN_EPS) * p["gamma"] + p["beta"]


def _mlp_block(p, x):
    return torch.relu(_bn_eval(p["bn"], _linear(p["linear"], x)))


def keypoint_encoder(p: Dict, kpts_norm, scores):
    """(K,2) normalized keypoints + (K,) scores -> (K,256)."""
    x = torch.cat([kpts_norm, scores[:, None]], dim=-1)
    for blk in p["blocks"]:
        x = _mlp_block(blk, x)
    return _linear(p["final"], x)


def _attention(p: Dict, x, source):
    """4-head scaled dot-product attention + output projection; x (K,256)
    queries, source (Ks,256) keys and values."""
    K, Ks = x.shape[0], source.shape[0]
    hd = HIDDEN // HEADS
    q = _linear(p["q"], x).reshape(K, HEADS, hd).transpose(0, 1)
    k = _linear(p["k"], source).reshape(Ks, HEADS, hd).transpose(0, 1)
    v = _linear(p["v"], source).reshape(Ks, HEADS, hd).transpose(0, 1)
    att = torch.softmax(q @ k.transpose(1, 2) / np.float32(math.sqrt(hd)), dim=-1)
    out = (att @ v).transpose(0, 1).reshape(K, HIDDEN)
    return _linear(p["out"], out)


def _propagate(p: Dict, x, source):
    msg = _attention(p, x, source)
    h = _mlp_block(p["mlp0"], torch.cat([x, msg], dim=-1))
    return _linear(p["mlp1"], h)


def gnn(p: Dict, xa, xb):
    for lp, lt in zip(p["layers"], LAYER_TYPES):
        if lt == "self":
            da, db = _propagate(lp, xa, xa), _propagate(lp, xb, xb)
        else:
            da, db = _propagate(lp, xa, xb), _propagate(lp, xb, xa)
        xa, xb = xa + da, xb + db
    return xa, xb


def log_optimal_transport(scores, bin_score, iters: int):
    """Dustbin-augmented log-space Sinkhorn (the official
    ``log_optimal_transport``, SuperGlue paper eq. 8-9)."""
    m, n = scores.shape
    dev, dt = scores.device, scores.dtype
    bins = torch.as_tensor(bin_score, dtype=dt, device=dev)
    couplings = torch.cat([torch.cat([scores, bins.expand(m, 1)], 1),
                           torch.cat([bins.expand(1, n), bins.expand(1, 1)], 1)], 0)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    norm = -torch.log(f(m + n))
    log_mu = torch.cat([norm.expand(m), (torch.log(f(n)) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(f(m)) + norm)[None]])
    u = torch.zeros(m + 1, dtype=dt, device=dev)
    v = torch.zeros(n + 1, dtype=dt, device=dev)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], dim=0)
    return couplings + u[:, None] + v[None, :] - norm


def normalize_keypoints(uv, width, height):
    """The official normalization: centred, scaled by 0.7 x the larger side."""
    size = torch.tensor([width, height], dtype=torch.float32, device=uv.device)
    return (uv - (size / 2.0)[None]) / (torch.max(size) * 0.7)


@torch.no_grad()
def superglue_apply(params: Dict, kpts_a, sc_a, desc_a, kpts_b, sc_b, desc_b,
                    width: float, height: float, iters: int = 100):
    """The official forward -> the (Ka+1, Kb+1) log-assignment matrix;
    keypoints in pixels, desc (K,256) at the pretrained scale, scores (K,)."""
    ka = normalize_keypoints(kpts_a, width, height)
    kb = normalize_keypoints(kpts_b, width, height)
    xa = desc_a + keypoint_encoder(params["kenc"], ka, sc_a)
    xb = desc_b + keypoint_encoder(params["kenc"], kb, sc_b)
    xa, xb = gnn(params["gnn"], xa, xb)
    ma = _linear(params["final"], xa)
    mb = _linear(params["final"], xb)
    scores = (ma @ mb.T) / np.float32(math.sqrt(HIDDEN))
    return log_optimal_transport(scores, params["bin_score"], iters)


def match_from_scores(Z, threshold: float = 0.2):
    """Mutual-max + threshold decode of the log-assignment (the official
    post-processing) -> (idx a->b (Ka,) int32, valid (Ka,), score (Ka,))."""
    inner = Z[:-1, :-1]
    idx0 = torch.argmax(inner, dim=1)
    idx1 = torch.argmax(inner, dim=0)
    rows = torch.arange(inner.shape[0], device=Z.device)
    mutual = rows == idx1[idx0]
    score = torch.where(mutual, torch.exp(inner[rows, idx0]), torch.zeros_like(inner[:, 0]))
    return idx0.to(torch.int32), mutual & (score > threshold), score


def to_device(params, device: DeviceLike = None):
    """The parameter tree (numpy, floats or tensors) as float32 tensors on
    ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: to_device(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, dev) for v in params]
    if isinstance(params, torch.Tensor):
        return params.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.array(params, np.float32)).to(dev)


def save_params(params: Dict, path: str) -> None:
    flat = {}

    def rec(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                rec(f"{prefix}/{i}", v)
        elif isinstance(obj, torch.Tensor):
            flat[prefix] = obj.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(obj)

    rec("", params)
    np.savez(path, **flat)


def load_params(path: str, device: DeviceLike = None) -> Dict:
    """The twin's npz layout -> the parameter tree on ``device`` (None = the
    CUDA card); a missing file raises."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    out: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        cur = out
        for i, p in enumerate(parts[:-1]):
            nxt_list = parts[i + 1].isdigit()
            if p.isdigit():
                p = int(p)
                while len(cur) <= p:
                    cur.append([] if nxt_list else {})
                cur = cur[p]
            else:
                if p not in cur:
                    cur[p] = [] if nxt_list else {}
                cur = cur[p]
        leaf = parts[-1]
        if leaf.isdigit():
            leaf = int(leaf)
            while len(cur) <= leaf:
                cur.append(None)
        cur[leaf] = val
    return to_device(out, device)

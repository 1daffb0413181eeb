"""Pretrained-weight converters: torch checkpoints -> the JAX package's npz
layout, so a converted checkpoint loads in either package.

Port of ``rtabmap_tpu/models/convert.py``. ``convert_superpoint`` takes a
MagicLeap-layout SuperPoint state dict (conv1a..convDb; ``torch.load`` or
``torch.jit.load(...).state_dict()``, or a path to such a file) to the
twin's ``Conv_i`` tree (HWIO kernels); ``convert_superglue`` takes the
official SuperGlue checkpoint, MagicLeap or HF-transformers layout, to the
tree ``models/superglue_official.py`` runs; ``convert_netvlad`` extracts a
NetVLAD layer's centroids (and alpha). The trees hold float32 numpy arrays,
as the twin's do.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# MagicLeap SuperPointNet layer order -> Conv_{i} of SuperPointNet
_SP_ORDER = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
             "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb"]


def _to_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _load_state_dict(src):
    if isinstance(src, dict):
        return src
    if isinstance(src, str):
        try:
            return torch.jit.load(src, map_location="cpu").state_dict()
        except Exception:
            obj = torch.load(src, map_location="cpu", weights_only=False)
            return obj.state_dict() if hasattr(obj, "state_dict") else obj
    if hasattr(src, "state_dict"):
        return src.state_dict()
    raise TypeError(f"cannot extract a state_dict from {type(src)}")


def convert_superpoint(src) -> Dict:
    """MagicLeap/rtabmap SuperPoint torch weights -> the twin's parameter
    tree ``{Conv_i: {kernel (kh, kw, in, out), bias}}``; torch Conv2d
    kernels are (out, in, kh, kw)."""
    sd = _load_state_dict(src)
    # names without their module prefixes
    norm = {}
    for k, v in sd.items():
        base = k.split(".")[-2] if "." in k else k
        norm[(base, k.split(".")[-1])] = _to_numpy(v)
    params = {}
    for i, name in enumerate(_SP_ORDER):
        w = norm.get((name, "weight"))
        b = norm.get((name, "bias"))
        if w is None:
            raise KeyError(f"missing layer '{name}' in SuperPoint checkpoint "
                           f"(found: {sorted({k[0] for k in norm})})")
        params[f"Conv_{i}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
            "bias": (np.zeros(w.shape[0], np.float32) if b is None else b.astype(np.float32)),
        }
    return params


def convert_superpoint_file(src_path: str, out_npz: str) -> None:
    """One-shot conversion: superpoint_v1.pt -> the npz that
    ``SuperPoint.load_params`` of either package reads."""
    params = convert_superpoint(src_path)
    np.savez(out_npz, **{f"{layer}/{leaf}": arr for layer, leaves in params.items()
                         for leaf, arr in leaves.items()})


def convert_netvlad(src) -> Dict:
    """NetVLAD checkpoint -> {codebook (K,D), alpha}: a dict with explicit
    ``centroids`` or a torch state dict with ``centroids`` / ``conv.weight``
    entries (the common torch NetVLAD ports)."""
    sd = _load_state_dict(src)
    cent = alpha = None
    for k, v in sd.items():
        lk = k.lower()
        if "centroid" in lk or lk.endswith("clusters") or lk == "codebook":
            cent = _to_numpy(v)
        if lk == "alpha":
            alpha = float(_to_numpy(v))
    if cent is None:
        raise KeyError(f"no centroids found in NetVLAD checkpoint (keys: {sorted(sd)[:8]}...)")
    if cent.ndim != 2:
        cent = cent.reshape(cent.shape[0], -1)
    out = {"codebook": cent.astype(np.float32)}
    if alpha is not None:
        out["alpha"] = alpha
    return out


# ------------------------------------------------------- SuperGlue official


def _lin(w, b):
    w = _to_numpy(w)
    if w.ndim == 3:          # MagicLeap Conv1d (out, in, 1)
        w = w[:, :, 0]
    return {"w": w.astype(np.float32), "b": _to_numpy(b).astype(np.float32)}


def _bn(sd, prefix):
    return {"gamma": _to_numpy(sd[f"{prefix}.weight"]).astype(np.float32),
            "beta": _to_numpy(sd[f"{prefix}.bias"]).astype(np.float32),
            "mean": _to_numpy(sd[f"{prefix}.running_mean"]).astype(np.float32),
            "var": _to_numpy(sd[f"{prefix}.running_var"]).astype(np.float32)}


def _gnn_layers(sd, names) -> list:
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("gnn.layers."))
    layers = []
    for i in range(n_layers):
        g = f"gnn.layers.{i}"
        lin = lambda key: _lin(sd[f"{g}.{names[key]}.weight"], sd[f"{g}.{names[key]}.bias"])  # noqa: E731,B023
        layers.append({"q": lin("q"), "k": lin("k"), "v": lin("v"), "out": lin("out"),
                       "mlp0": {"linear": lin("mlp0"), "bn": _bn(sd, f"{g}.{names['bn']}")},
                       "mlp1": lin("mlp1")})
    return layers


_HF_GNN = {"q": "attention.self.query", "k": "attention.self.key",
           "v": "attention.self.value", "out": "attention.output.dense",
           "mlp0": "mlp.0.linear", "bn": "mlp.0.batch_norm", "mlp1": "mlp.1"}
_ML_GNN = {"q": "attn.proj.0", "k": "attn.proj.1", "v": "attn.proj.2", "out": "attn.merge",
           "mlp0": "mlp.0", "bn": "mlp.1", "mlp1": "mlp.3"}


def convert_superglue(src) -> Dict:
    """Official SuperGlue checkpoint -> the parameter tree of
    ``models.superglue_official.superglue_apply``: the MagicLeap layout
    (superglue_indoor.pth: kenc.encoder Conv1d sequential,
    gnn.layers.N.attn.proj.{0,1,2} / attn.merge, mlp Conv1d sequential,
    final_proj, bin_score) or the HF-transformers one
    (keypoint_encoder.encoder.N.linear/batch_norm,
    gnn.layers.N.attention.self.query|key|value / attention.output.dense,
    mlp.0.linear/batch_norm + mlp.1, final_projection.final_proj)."""
    sd = _load_state_dict(src)
    hf = any(k.startswith("keypoint_encoder.") for k in sd)
    ml = any(k.startswith("kenc.") for k in sd)
    if not hf and not ml:
        raise KeyError(f"unrecognized SuperGlue layout (keys: {sorted(sd)[:6]}...)")
    if hf:
        enc = "keypoint_encoder.encoder"
        blocks = [{"linear": _lin(sd[f"{enc}.{i}.linear.weight"], sd[f"{enc}.{i}.linear.bias"]),
                   "bn": _bn(sd, f"{enc}.{i}.batch_norm")} for i in range(4)]
        kenc = {"blocks": blocks, "final": _lin(sd[f"{enc}.4.weight"], sd[f"{enc}.4.bias"])}
        final = _lin(sd["final_projection.final_proj.weight"],
                     sd["final_projection.final_proj.bias"])
    else:
        # MagicLeap sequential: convs at 0,3,6,9 with BN at 1,4,7,10 (ReLU
        # between), the final conv at 12
        blocks = [{"linear": _lin(sd[f"kenc.encoder.{c}.weight"], sd[f"kenc.encoder.{c}.bias"]),
                   "bn": _bn(sd, f"kenc.encoder.{c + 1}")} for c in (0, 3, 6, 9)]
        kenc = {"blocks": blocks,
                "final": _lin(sd["kenc.encoder.12.weight"], sd["kenc.encoder.12.bias"])}
        final = _lin(sd["final_proj.weight"], sd["final_proj.bias"])
    return {"gnn": {"layers": _gnn_layers(sd, _HF_GNN if hf else _ML_GNN)}, "kenc": kenc,
            "final": final, "bin_score": float(_to_numpy(sd["bin_score"]))}

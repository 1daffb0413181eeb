"""SuperPoint keypoint detector + descriptor.

Port of ``rtabmap_tpu/models/superpoint.py`` (the reference's SuperPoint
wrapper: VGG encoder, 65-channel detector head, 256-D descriptor head, NMS,
top-k, bilinear descriptor sampling). The network is an ``nn.Module``, NCHW
inside, whose outputs are laid out as the twin's (NHWC). Weights load from
the twin's npz layout (``Conv_i/kernel`` HWIO, ``Conv_i/bias``) through
``params_from_flax``.

``dtype`` bfloat16 (the default, as in the twin) mirrors the rounding of
the twin's compiled network (``SuperPointNet._conv``): the input, kernels
and biases are cast to bfloat16, each convolution's output is rounded to
bfloat16 before its bias is added, and so is the sum, ReLU and the 2x2
max-pool run in bfloat16; the two heads' outputs come out in float32. ``extract`` sign-binarizes the sampled
descriptors (0 goes to +1) into the +-1 int8 convention that the
vocabulary and the matchers take.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.ops import features as FT

CELL = 8  # encoder stride; the detector head gives CELL*CELL+1 logits a cell

# (in, out, kernel) of Conv_0..Conv_11 in the twin's call order: the VGG
# encoder, the detector head (convPa, convPb) and the descriptor head
# (convDa, convDb)
_LAYERS = ((1, 64, 3), (64, 64, 3), (64, 64, 3), (64, 64, 3), (64, 128, 3),
           (128, 128, 3), (128, 128, 3), (128, 128, 3), (128, 256, 3), (256, 65, 1),
           (128, 256, 3), (256, None, 1))
WEIGHTS = os.path.join(os.path.dirname(__file__), "weights", "superpoint_distilled.npz")


class SuperPointNet(nn.Module):
    """VGG-style shared encoder + detector/descriptor heads."""

    def __init__(self, desc_dim: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.desc_dim = desc_dim
        self.dtype = dtype
        self.convs = nn.ModuleList(
            nn.Conv2d(i, desc_dim if o is None else o, k, padding=k // 2)
            for i, o, k in _LAYERS)

    def _conv(self, i: int, x: torch.Tensor, last: bool = False) -> torch.Tensor:
        """Conv_i, its bias and (but for the heads' last layers) ReLU. In
        bfloat16 as the twin's compiled graph computes it: the product of
        bfloat16 operands summed in float32 and rounded to bfloat16, the
        bias added in float32 and the sum rounded to bfloat16; the heads'
        outputs keep the float32 sum (XLA drops that last rounding before
        the cast to float32)."""
        c = self.convs[i]
        w, b = c.weight.to(self.dtype), c.bias.to(self.dtype)[None, :, None, None]
        if self.dtype == torch.float32:
            y = F.conv2d(x, w, padding=c.padding) + b
            return y if last else torch.relu(y)
        if x.is_cuda:   # cuDNN: bfloat16 operands, float32 accumulation
            y = F.conv2d(x, w, padding=c.padding)
        else:           # the same products, exact in float32
            y = F.conv2d(x.float(), w.float(), padding=c.padding).to(self.dtype)
        y = y.float() + b.float()
        return y if last else torch.relu(y.to(self.dtype))

    def forward(self, x: torch.Tensor):
        """x (N, H, W, 1) float32 in [0,1], H and W multiples of 8 ->
        (logits (N, H/8, W/8, 65), descriptors (N, H/8, W/8, D)) float32."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(8):
            x = self._conv(i, x)
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        logits = self._conv(9, self._conv(8, x), last=True)
        desc = self._conv(11, self._conv(10, x), last=True)
        return (logits.float().permute(0, 2, 3, 1), desc.float().permute(0, 2, 3, 1))


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The twin's parameters (``Conv_i/kernel`` HWIO, ``Conv_i/bias``; the
    bundled npz holds float16, widened to float32 as the twin does) -> a
    ``SuperPointNet`` state dict (OIHW float32)."""
    out = {}
    for i in range(len(_LAYERS)):
        w = np.asarray(flat[f"Conv_{i}/kernel"], np.float32)
        out[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = torch.from_numpy(np.array(flat[f"Conv_{i}/bias"], np.float32))
    return out


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_flax``: the twin's npz layout, float32."""
    out = {}
    for i in range(len(_LAYERS)):
        w = state[f"convs.{i}.weight"].detach().cpu().float().numpy()
        out[f"Conv_{i}/kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        out[f"Conv_{i}/bias"] = state[f"convs.{i}.bias"].detach().cpu().float().numpy()
    return out


def score_map_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """(N, Hc, Wc, 65) -> dense (N, H, W) keypoint probability: softmax over
    the 65 cell classes, the dustbin dropped, channel cy*8 + cx of cell
    (hc, wc) at pixel (hc*8 + cy, wc*8 + cx)."""
    prob = torch.softmax(logits, dim=-1)[..., :-1]
    n, hc, wc, _ = prob.shape
    prob = prob.reshape(n, hc, wc, CELL, CELL)
    return prob.permute(0, 1, 3, 2, 4).reshape(n, hc * CELL, wc * CELL)


def _sample_descriptors(desc_map: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear descriptor lookup at pixel coords uv (K,2) on the coarse
    (Hc, Wc, D) map; returns L2-normalized (K, D) float32."""
    hc, wc, dd = desc_map.shape
    cu = torch.clamp((uv[:, 0] + 0.5) / CELL - 0.5, 0.0, wc - 1.0)
    cv = torch.clamp((uv[:, 1] + 0.5) / CELL - 0.5, 0.0, hc - 1.0)
    u0 = torch.floor(cu).long()
    v0 = torch.floor(cv).long()
    u1 = torch.clamp(u0 + 1, max=wc - 1)
    v1 = torch.clamp(v0 + 1, max=hc - 1)
    fu = (cu - u0)[:, None]
    fv = (cv - v0)[:, None]
    flat = desc_map.reshape(-1, dd)
    g = lambda vv, uu: flat[vv * wc + uu]  # noqa: E731
    d = ((1 - fv) * (1 - fu) * g(v0, u0) + (1 - fv) * fu * g(v0, u1)
         + fv * (1 - fu) * g(v1, u0) + fv * fu * g(v1, u1))
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def postprocess(logits: torch.Tensor, desc_map: torch.Tensor, max_kp: int, nms_size: int,
                conf_threshold: float, use_grid: bool = False):
    """The network's outputs of one image (1, Hc, Wc, 65) and (1, Hc, Wc, D)
    -> (Keypoints(max_kp), desc +-1 int8, descf float32): NMS and top-k on
    the score map (8 px border), ``conf_threshold`` applied after the
    top-k, descriptors sampled and sign-binarized, invalid rows zero."""
    score = score_map_from_logits(logits)[0]
    select = FT.select_top_k_grid if use_grid else FT.select_top_k
    kps = select(score, max_kp, nms_size=nms_size, quality_level=0.0, border=CELL)
    kps = kps._replace(valid=kps.valid & (kps.response > conf_threshold))
    descf = _sample_descriptors(desc_map[0], kps.uv)
    desc = torch.where(descf >= 0, 1, -1).to(torch.int8)
    desc = torch.where(kps.valid[:, None], desc, torch.zeros_like(desc))
    return kps, desc, descf


class SuperPoint:
    """Owns the network on ``device`` (None = the CUDA card) and extracts."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None, desc_dim: int = 256,
                 seed: int = 0, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.desc_dim = desc_dim
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)   # seeded random weights when params is None
            self.net = SuperPointNet(desc_dim=desc_dim, dtype=dtype)
        if params is not None:
            self.net.load_state_dict(params)
        self.net.to(self.device).eval()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    @torch.no_grad()
    def forward(self, gray) -> tuple:
        """gray (H, W) -> the network's (logits, descriptors), NHWC float32."""
        g = (gray.to(device=self.device, dtype=torch.float32) if isinstance(gray, torch.Tensor)
             else torch.from_numpy(np.array(gray, np.float32)).to(self.device))
        return self.net(g[None, :, :, None])

    @torch.no_grad()
    def extract(self, gray, max_kp: int = 512, nms_size: int = 9,
                conf_threshold: float = 0.005, use_grid: bool = False):
        """gray (H, W) float32 in [0,1], H and W multiples of 8 ->
        (Keypoints(max_kp), desc +-1 int8 (max_kp, D), descf float32 (max_kp, D))."""
        logits, desc_map = self.forward(gray)
        return postprocess(logits, desc_map, max_kp, nms_size, conf_threshold, use_grid)

    # ------------------------------------------------------------ persistence

    def save_params(self, path: str):
        """The twin's npz layout (``Conv_i/kernel`` HWIO float32)."""
        np.savez(path, **params_to_flax(self.params))

    @classmethod
    def load_params(cls, path: str, desc_dim: int = 256, device: DeviceLike = None,
                    dtype: torch.dtype = torch.bfloat16) -> "SuperPoint":
        """Either package's npz (a missing file raises)."""
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        params = params_from_flax(flat)
        for i, (_, o, k) in enumerate(_LAYERS):
            shape = tuple(params[f"convs.{i}.weight"].shape)
            want = (desc_dim if o is None else o, _LAYERS[i][0], k, k)
            if shape != want:
                raise ValueError(f"Conv_{i}/kernel of {path} has shape {shape}, not {want}")
        return cls(params=params, desc_dim=desc_dim, device=device, dtype=dtype)

    @classmethod
    def distilled(cls, desc_dim: int = 256, device: DeviceLike = None,
                  dtype: torch.dtype = torch.bfloat16) -> "SuperPoint":
        """The bundled self-distilled weights (``weights/superpoint_distilled.npz``,
        a byte-identical copy of the JAX package's)."""
        if not os.path.exists(WEIGHTS):
            raise FileNotFoundError(f"{WEIGHTS} missing")
        return cls.load_params(WEIGHTS, desc_dim=desc_dim, device=device, dtype=dtype)

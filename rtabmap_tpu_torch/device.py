"""Device selection shared by the port's entry points.

Every entry point takes ``device``: ``None`` means the CUDA card and raises
when there is none — the port never moves quietly to the CPU. Tests pass
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
``to_numpy`` brings a tensor or an array to the host.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def to_numpy(x) -> Optional[np.ndarray]:
    """A tensor on any device, or an array, as a host numpy array; None stays None."""
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

"""LaserScan: a typed fixed-capacity point-cloud buffer.

Port of ``rtabmap_tpu/core/laser_scan.py`` (the reference's ``LaserScan``:
XYZ/XYZI/XYZRGB/XYZNormal formats, 2-D or 3-D, maximum range, local
transform). An (N,C) float32 tensor + channel-layout tag + validity mask,
so a scan drops straight into the ICP and occupancy code. The tensors
live on one device (the engine's); ``to`` moves a scan.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Optional

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device


class ScanFormat(IntEnum):
    XYZ = 0
    XYZI = 1
    XYZRGB = 2
    XYZN = 3        # + normals
    XYZIN = 4
    XY = 10         # 2D
    XYI = 11
    XYN = 13


_CHANNELS = {
    ScanFormat.XYZ: 3, ScanFormat.XYZI: 4, ScanFormat.XYZRGB: 6,
    ScanFormat.XYZN: 6, ScanFormat.XYZIN: 7,
    ScanFormat.XY: 2, ScanFormat.XYI: 3, ScanFormat.XYN: 4,
}


class LaserScan(NamedTuple):
    data: torch.Tensor           # (N, C) float32
    valid: torch.Tensor          # (N,) bool
    format: int
    max_range: float = 0.0
    local_transform: Optional[torch.Tensor] = None  # (3,4) sensor in base

    @property
    def is_2d(self) -> bool:
        return self.format >= ScanFormat.XY

    @property
    def has_normals(self) -> bool:
        return self.format in (ScanFormat.XYZN, ScanFormat.XYZIN, ScanFormat.XYN)

    def xyz(self) -> torch.Tensor:
        if self.is_2d:
            z = torch.zeros((self.data.shape[0], 1), dtype=self.data.dtype,
                            device=self.data.device)
            return torch.cat([self.data[:, :2], z], dim=-1)
        return self.data[:, :3]

    def normals(self) -> Optional[torch.Tensor]:
        if not self.has_normals:
            return None
        if self.format == ScanFormat.XYN:
            n2 = self.data[:, 2:4]
            return torch.cat([n2, torch.zeros_like(n2[:, :1])], dim=-1)
        off = 4 if self.format == ScanFormat.XYZIN else 3
        return self.data[:, off:off + 3]

    def to(self, device) -> "LaserScan":
        """The same scan with its tensors on ``device`` (itself when they
        are there already)."""
        device = torch.device(device)
        if self.data.device == device:
            return self
        lt = self.local_transform
        return self._replace(data=self.data.to(device), valid=self.valid.to(device),
                             local_transform=None if lt is None else lt.to(device))


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_scan(points, fmt: ScanFormat = ScanFormat.XYZ, valid=None,
              max_range: float = 0.0, capacity: Optional[int] = None,
              local_transform=None, device: DeviceLike = None) -> LaserScan:
    """A scan of (N,C) ``points`` in format ``fmt`` on ``device`` (None =
    the points' device when they are a tensor, else the CUDA card), padded
    with invalid rows or cut to ``capacity``."""
    if device is None and isinstance(points, torch.Tensor):
        dev = points.device
    else:
        dev = resolve_device(device)
    pts = _tensor(points, torch.float32, dev)
    n = pts.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else _tensor(valid, torch.bool, dev))
    if capacity is not None and capacity != n:
        if capacity < n:
            pts, valid = pts[:capacity], valid[:capacity]
        else:
            pts = torch.nn.functional.pad(pts, (0, 0, 0, capacity - n))
            valid = torch.nn.functional.pad(valid, (0, capacity - n))
    assert pts.shape[1] == _CHANNELS[fmt], (pts.shape, fmt)
    return LaserScan(data=pts, valid=valid, format=int(fmt), max_range=max_range,
                     local_transform=None if local_transform is None
                     else _tensor(local_transform, torch.float32, dev))


def valid_first(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` rows in valid-first order: the valid rows
    in index order, then the invalid ones. The JAX twin's
    ``lax.top_k(mask - arange * 1e-9, k)`` picks the same rows (its float32
    priorities tie within a class, and ties go to the lower index)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)[:k]


def scan_from_depth(depth: torch.Tensor, cam, decimation: int = 8, max_range: float = 8.0,
                    capacity: int = 4096) -> LaserScan:
    """Depth image -> 3-D scan slab (reference: util3d::scanFromDepth), in
    the valid-first order of the JAX twin: the voxel filter keeps the first
    point of each cell, so the order decides the kept set."""
    from rtabmap_tpu_torch.ops import cloud as CL

    pts, ok = CL.cloud_from_depth(depth, cam, decimation=decimation, max_depth=max_range)
    idx = valid_first(ok, min(capacity, pts.shape[0]))
    return make_scan(pts[idx], ScanFormat.XYZ, ok[idx], max_range, capacity,
                     device=depth.device)

"""3-D nearest neighbour: the hand-written Hopper kernel and its plain version.

Replaces ``rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d``, the TPU kernel of
the ICP correspondence search (``ops/icp.py::_nn_blocked``, reached by
``icp``, ``register_scans`` and the scan-odometry keyframe merge).

- ``nn3d`` is the wrapper of ``csrc/nn3d.cu``. On CUDA tensors it launches
  the kernel or raises; on CPU tensors it runs ``nn3d_reference``.
  ``nn3d.launches`` counts kernel launches.
- ``nn3d_reference`` is the plain PyTorch version; the CPU tests hold it
  against the Pallas kernel in interpret mode, and ``chip_smoke.py`` holds
  the kernel against it on the card.

Both meet one contract bit for bit: ``d = ((dx*dx + dy*dy) + dz*dz) + pen``
with every operation rounded on its own, pen 0 for a valid point and +inf
otherwise; the (d, idx) lexicographic minimum, so ties go to the lowest
index; (+inf, 0) when no point is valid; any Q >= 0 and N >= 1. The TPU
kernel's limits (Q % 512, N % 2048) do not carry over. What bounds the
kernel on the card, and what its design does about that, is noted in the
CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rtabmap_tpu_torch.ops.cuda import build

SOURCE = "nn3d"
# queries per step of the plain version: bounds its (rows, N) temporaries
_PLAIN_PAIRS = 1 << 24


def nn3d_reference(src: torch.Tensor, dst: torch.Tensor,
                   dst_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch 1-NN with the kernel's exact contract, chunked over
    queries so that the (Q, N) distance matrix never sits whole in memory."""
    Q, N = src.shape[0], dst.shape[0]
    pen = torch.where(dst_valid, 0.0, float("inf")).to(torch.float32)
    bx, by, bz = dst[:, 0], dst[:, 1], dst[:, 2]
    out_d = torch.empty((Q,), dtype=torch.float32, device=src.device)
    out_i = torch.empty((Q,), dtype=torch.int32, device=src.device)
    rows = max(1, _PLAIN_PAIRS // max(N, 1))
    for q0 in range(0, Q, rows):
        q = src[q0:q0 + rows]
        # ((dx*dx + dy*dy) + dz*dz) + pen, one rounding an operation, in place
        d2 = q[:, 0:1] - bx
        d2.mul_(d2)
        d = q[:, 1:2] - by
        d2.add_(d.mul_(d))
        d = q[:, 2:3] - bz
        d2.add_(d.mul_(d)).add_(pen)
        m, i = torch.min(d2, dim=1)   # first index of the minimum
        out_d[q0:q0 + rows] = m
        out_i[q0:q0 + rows] = i.to(torch.int32)
    return out_d, out_i


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn3d.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
        lib.nn3d.restype = i
        lib.nn3d_error_string.argtypes = [i]
        lib.nn3d_error_string.restype = ctypes.c_char_p
        lib.nn3d_block_queries.restype = i
        lib.nn3d_tile_points.restype = i
        lib._typed = True
    return lib


def _check(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor):
    if src.dim() != 2 or src.shape[1] != 3 or src.dtype != torch.float32:
        raise ValueError(f"src must be (Q,3) float32, got {tuple(src.shape)} {src.dtype}")
    if dst.dim() != 2 or dst.shape[1] != 3 or dst.dtype != torch.float32:
        raise ValueError(f"dst must be (N,3) float32, got {tuple(dst.shape)} {dst.dtype}")
    if dst_valid.shape != (dst.shape[0],) or dst_valid.dtype != torch.bool:
        raise ValueError(f"dst_valid must be ({dst.shape[0]},) bool, got "
                         f"{tuple(dst_valid.shape)} {dst_valid.dtype}")
    if dst.shape[0] < 1:
        raise ValueError("dst must hold at least one point")
    if max(src.shape[0], dst.shape[0]) >= 2 ** 31 // 3:
        raise ValueError("nn3d indexes points with int32")
    if not (src.device == dst.device == dst_valid.device):
        raise ValueError("src, dst and dst_valid must share a device")


def _chunking(n_qtiles: int, N: int, tile: int, device) -> Tuple[int, int]:
    """Destination chunk size (a multiple of the kernel's tile) giving
    about eight blocks per SM over the (query tile, chunk) grid."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_chunks = -(-N // tile)
    n_chunks = max(1, min(max_chunks, -(-8 * sms // n_qtiles)))
    chunk_pts = -(-(-(-N // n_chunks)) // tile) * tile
    return chunk_pts, -(-N // chunk_pts)


def nn3d(src: torch.Tensor, dst: torch.Tensor,
         dst_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """src (Q,3) f32, dst (N,3) f32, dst_valid (N,) bool ->
    (dist2 (Q,) f32, idx (Q,) int32) of each query's nearest valid point."""
    _check(src, dst, dst_valid)
    if src.device.type == "cpu":
        return nn3d_reference(src, dst, dst_valid)
    if src.device.type != "cuda":
        raise RuntimeError(f"nn3d runs on CPU or CUDA tensors, not {src.device}")
    for name, t in (("src", src), ("dst", dst), ("dst_valid", dst_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Q, N = src.shape[0], dst.shape[0]
    dev = src.device
    dist2 = torch.empty((Q,), dtype=torch.float32, device=dev)
    idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q == 0:
        return dist2, idx
    lib = _library()
    n_qtiles = -(-Q // lib.nn3d_block_queries())
    chunk_pts, n_chunks = _chunking(n_qtiles, N, lib.nn3d_tile_points(), dev)
    scratch = torch.empty((Q, n_chunks if n_chunks > 1 else 0, 2),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn3d(src.data_ptr(), dst.data_ptr(), dst_valid.data_ptr(), Q, N,
                       chunk_pts, n_chunks, scratch.data_ptr(), dist2.data_ptr(),
                       idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("nn3d launch failed: " + lib.nn3d_error_string(err).decode())
    nn3d.launches += 1
    return dist2, idx


nn3d.launches = 0

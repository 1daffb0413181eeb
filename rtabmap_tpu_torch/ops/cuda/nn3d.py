"""3-D nearest neighbour: the hand-written Hopper kernel and its plain version.

Replaces ``rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d``, the TPU kernel of
the ICP correspondence search (``ops/icp.py::_nn_blocked``, reached by
``icp``, ``register_scans`` and the scan-odometry keyframe merge).

- ``nn3d_prepare`` takes a destination and, optionally, a query mask and
  returns an ``Nn3dPlan``; on CUDA tensors it launches ``nn3d_compact``
  (the valid points and queries compacted in order, counts kept on the
  device). ``nn3d_search`` runs one search of a plan; on CUDA tensors it
  launches ``nn3d_chunks`` + ``nn3d_merge``. A plan serves every search
  of one ``icp()`` call: the destination and both masks stay fixed there.
  ``nn3d`` is the two in one call. On CUDA tensors each launches its
  kernel or raises; on CPU tensors they run the plain versions.
  ``nn3d_prepare.launches`` and ``nn3d_search.launches`` count launches.
- ``nn3d_reference`` and ``nn3d_compact_reference`` are the plain PyTorch
  versions; the CPU tests hold the first against the Pallas kernel in
  interpret mode, and ``chip_smoke.py`` holds both kernels against them on
  the card. Nothing here syncs with the host.

Both meet one contract bit for bit: ``d = (dx*dx + dy*dy) + dz*dz`` with
every operation rounded on its own, over the valid points only; the (d,
idx) lexicographic minimum, so ties go to the lowest index; (+inf, 0) when
no point is valid, and (+inf, 0) for a query whose ``src_valid`` flag is
false (no search is made for it); any Q >= 0 and N >= 1. The TPU kernel's
limits (Q % 512, N % 2048) do not carry over. What bounds the kernel on
the card, and what its design does about that, is noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from rtabmap_tpu_torch.ops.cuda import build

SOURCE = "nn3d"
# queries per step of the plain version: bounds its (rows, N) temporaries
_PLAIN_PAIRS = 1 << 24
# search blocks an SM: the grid the host sizes from Q and N alone
_BLOCKS_PER_SM = 8


class Nn3dPlan(NamedTuple):
    """A destination (and query mask) prepared for ``nn3d_search``. On the
    card, written by ``nn3d_compact``: ``dst4`` (N,4) the valid points
    compacted in order as (x, y, z, 0), ``dlist`` (N,) their indices,
    ``qlist`` (Q,) the valid queries in order then the masked ones (None
    without a query mask), ``counts`` (2,) the numbers of valid points and
    valid queries; only the first ``counts[0]`` rows of ``dst4`` and
    ``dlist`` are written. On the CPU all four are None."""
    dst: torch.Tensor
    dst_valid: torch.Tensor
    src_valid: Optional[torch.Tensor]
    dst4: Optional[torch.Tensor] = None
    dlist: Optional[torch.Tensor] = None
    qlist: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None


def nn3d_reference(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor,
                   src_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch 1-NN with the kernel's exact contract, chunked over
    queries so that the (Q, N) distance matrix never sits whole in memory."""
    Q, N = src.shape[0], dst.shape[0]
    bx, by, bz = dst[:, 0], dst[:, 1], dst[:, 2]
    out_d = torch.empty((Q,), dtype=torch.float32, device=src.device)
    out_i = torch.empty((Q,), dtype=torch.int32, device=src.device)
    rows = max(1, _PLAIN_PAIRS // max(N, 1))
    for q0 in range(0, Q, rows):
        q = src[q0:q0 + rows]
        # (dx*dx + dy*dy) + dz*dz, one rounding an operation, in place
        d2 = q[:, 0:1] - bx
        d2.mul_(d2)
        d = q[:, 1:2] - by
        d2.add_(d.mul_(d))
        d = q[:, 2:3] - bz
        d2.add_(d.mul_(d)).masked_fill_(~dst_valid, float("inf"))
        m, i = torch.min(d2, dim=1)   # first index of the minimum
        out_d[q0:q0 + rows] = m
        out_i[q0:q0 + rows] = i.to(torch.int32)
    if src_valid is not None:
        out_d.masked_fill_(~src_valid, float("inf"))
        out_i.masked_fill_(~src_valid, 0)
    return out_d, out_i


def nn3d_compact_reference(dst: torch.Tensor, dst_valid: torch.Tensor,
                           src_valid: Optional[torch.Tensor] = None):
    """Plain version of ``nn3d_compact``: (dst4 (np,4), dlist (np,),
    qlist (Q,) or None, counts (2,)), the valid points in order with a
    zero fourth lane, their indices, the valid queries in order then the
    masked ones, and (np, nq)."""
    dlist = torch.nonzero(dst_valid)[:, 0].to(torch.int32)
    dst4 = torch.cat([dst[dlist.long()], dst.new_zeros((dlist.numel(), 1))], dim=1)
    if src_valid is None:
        return dst4, dlist, None, torch.tensor([dlist.numel(), 0], dtype=torch.int32)
    qlist = torch.cat([torch.nonzero(src_valid)[:, 0],
                       torch.nonzero(~src_valid)[:, 0]]).to(torch.int32)
    counts = torch.tensor([dlist.numel(), int(src_valid.sum())], dtype=torch.int32)
    return dst4, dlist, qlist, counts


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn3d_compact_launch.argtypes = [p, p, i, p, i, p, p, p, p, p]
        lib.nn3d_compact_launch.restype = i
        lib.nn3d_search.argtypes = [p, p, p, p, p, i, i, p, p, p, p]
        lib.nn3d_search.restype = i
        lib.nn3d_error_string.argtypes = [i]
        lib.nn3d_error_string.restype = ctypes.c_char_p
        lib.nn3d_block_queries.restype = i
        lib.nn3d_min_chunk.restype = i
        lib._typed = True
    return lib


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.nn3d_error_string(err).decode())


def _check_points(name: str, t: torch.Tensor):
    if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.float32:
        raise ValueError(f"{name} must be (n,3) float32, got {tuple(t.shape)} {t.dtype}")


def _check_mask(name: str, m: torch.Tensor, n: int):
    if m.shape != (n,) or m.dtype != torch.bool:
        raise ValueError(f"{name} must be ({n},) bool, got {tuple(m.shape)} {m.dtype}")


def _on_card(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("nn3d's tensors must share a device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"nn3d runs on CPU or CUDA tensors, not {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("nn3d's tensors must be contiguous")
    return True


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nn3d_prepare(dst: torch.Tensor, dst_valid: torch.Tensor,
                 src_valid: Optional[torch.Tensor] = None) -> Nn3dPlan:
    """Prepare dst (N,3) f32 with dst_valid (N,) bool, and the query mask
    src_valid (Q,) bool or None (every query valid), for ``nn3d_search``."""
    _check_points("dst", dst)
    _check_mask("dst_valid", dst_valid, dst.shape[0])
    N = dst.shape[0]
    if N < 1:
        raise ValueError("dst must hold at least one point")
    ts = (dst, dst_valid)
    Q = 0
    if src_valid is not None:
        Q = src_valid.shape[0] if src_valid.dim() == 1 else -1
        _check_mask("src_valid", src_valid, Q)
        ts += (src_valid,)
    if max(Q, N) >= 2 ** 31 // 4:
        raise ValueError("nn3d indexes points with int32")
    if not _on_card(*ts):
        return Nn3dPlan(dst, dst_valid, src_valid)
    dev = dst.device
    dst4 = torch.empty((N, 4), dtype=torch.float32, device=dev)
    ints = torch.empty((N + Q + 2,), dtype=torch.int32, device=dev)
    dlist, qlist, counts = ints[:N], ints[N:N + Q], ints[N + Q:]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn3d_compact_launch(
            dst.data_ptr(), dst_valid.data_ptr(), N,
            None if src_valid is None else src_valid.data_ptr(), Q,
            dst4.data_ptr(), dlist.data_ptr(), qlist.data_ptr(), counts.data_ptr(),
            stream)
    _raise_on(lib, err, "nn3d_compact")
    nn3d_prepare.launches += 1
    return Nn3dPlan(dst, dst_valid, src_valid, dst4, dlist,
                    None if src_valid is None else qlist, counts)


def nn3d_search(src: torch.Tensor, plan: Nn3dPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """src (Q,3) f32 against a plan -> (dist2 (Q,) f32, idx (Q,) int32) of
    each query's nearest valid point; (+inf, 0) for a masked query."""
    _check_points("src", src)
    Q, N = src.shape[0], plan.dst.shape[0]
    if plan.src_valid is not None and plan.src_valid.shape[0] != Q:
        raise ValueError(f"the plan's query mask holds {plan.src_valid.shape[0]} "
                         f"flags for {Q} queries")
    if Q >= 2 ** 31 // 4:
        raise ValueError("nn3d indexes points with int32")
    if not _on_card(src, plan.dst):
        return nn3d_reference(src, plan.dst, plan.dst_valid, plan.src_valid)
    dev = src.device
    dist2 = torch.empty((Q,), dtype=torch.float32, device=dev)
    idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q == 0:
        return dist2, idx
    lib = _library()
    bq, min_chunk = lib.nn3d_block_queries(), lib.nn3d_min_chunk()
    q_tiles = -(-Q // bq)
    grid = min(_BLOCKS_PER_SM * _sm_count(dev.index if dev.index is not None
                                          else torch.cuda.current_device()),
               q_tiles * -(-N // min_chunk))
    scratch = torch.empty((max(grid, q_tiles) * bq, 2), dtype=torch.int32, device=dev)
    qlist = None if plan.qlist is None else plan.qlist.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn3d_search(src.data_ptr(), qlist, plan.dst4.data_ptr(),
                              plan.dlist.data_ptr(), plan.counts.data_ptr(), Q, grid,
                              scratch.data_ptr(), dist2.data_ptr(), idx.data_ptr(),
                              stream)
    _raise_on(lib, err, "nn3d_search")
    nn3d_search.launches += 1
    return dist2, idx


def nn3d(src: torch.Tensor, dst: torch.Tensor, dst_valid: torch.Tensor,
         src_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """src (Q,3) f32, dst (N,3) f32, dst_valid (N,) bool, src_valid (Q,)
    bool or None -> (dist2 (Q,) f32, idx (Q,) int32) of each query's
    nearest valid point; (+inf, 0) where src_valid is false."""
    _check_points("src", src)
    return nn3d_search(src, nn3d_prepare(dst, dst_valid, src_valid))


nn3d_prepare.launches = 0
nn3d_search.launches = 0

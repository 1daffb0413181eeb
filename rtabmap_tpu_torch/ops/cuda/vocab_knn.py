"""Vocabulary 2-NN: the hand-written Hopper kernel and its plain version.

Replaces ``rtabmap_tpu/ops/pallas/vocab_knn.py::pallas_knn2`` (and its
dispatch ``knn2``), the one TPU kernel of the appearance-only tick: exact
Hamming 2-NN of a frame's descriptors against the whole vocabulary slab.

- ``knn2`` is the wrapper of ``csrc/vocab_knn.cu``. On CUDA tensors it
  launches the kernel or raises; on CPU tensors it runs ``knn2_reference``.
  ``knn2.launches`` counts kernel launches.
- ``knn2_reference`` is the plain PyTorch version (``ops.matching.
  knn_blocked`` with k=2); the CPU tests use it, and ``chip_smoke.py``
  holds the kernel against it on the card.

Both meet one contract bit for bit: dist = (256 - q.s)/2 exact, invalid
words excluded, a missing neighbour is (1e9, idx 0), ranks in (dist, idx)
lexicographic order, any Q >= 1 and W >= 1. What bounds the kernel on the
card, and what its design does about that (int8 tensor cores, queries held
in registers, a cp.async ring of slab tiles), is noted in the CUDA source.
The dictionary passes only the valid prefix of its slab
(``vocab/dictionary.py``), so W is the vocabulary's size, not its capacity.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rtabmap_tpu_torch.ops.cuda import build
from rtabmap_tpu_torch.ops.features import DESC_DIM
from rtabmap_tpu_torch.ops.matching import knn_blocked

SOURCE = "vocab_knn"


def knn2_reference(query: torch.Tensor, slab: torch.Tensor,
                   slab_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch 2-NN with the kernel's exact contract."""
    return knn_blocked(query, slab, k=2, base_valid=slab_valid)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vocab_knn2.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
        lib.vocab_knn2.restype = i
        lib.vocab_knn2_error_string.argtypes = [i]
        lib.vocab_knn2_error_string.restype = ctypes.c_char_p
        lib.vocab_knn2_block_queries.restype = i
        lib.vocab_knn2_block_rows.restype = i
        lib._typed = True
    return lib


def _check(query: torch.Tensor, slab: torch.Tensor, slab_valid: torch.Tensor):
    if query.dim() != 2 or query.shape[1] != DESC_DIM or query.dtype != torch.int8:
        raise ValueError(f"query must be (Q,{DESC_DIM}) int8, got "
                         f"{tuple(query.shape)} {query.dtype}")
    if slab.dim() != 2 or slab.shape[1] != DESC_DIM or slab.dtype != torch.int8:
        raise ValueError(f"slab must be (W,{DESC_DIM}) int8, got "
                         f"{tuple(slab.shape)} {slab.dtype}")
    if slab_valid.shape != (slab.shape[0],) or slab_valid.dtype != torch.bool:
        raise ValueError(f"slab_valid must be ({slab.shape[0]},) bool, got "
                         f"{tuple(slab_valid.shape)} {slab_valid.dtype}")
    if slab.shape[0] < 1:
        raise ValueError("slab must hold at least one row")
    if not (query.device == slab.device == slab_valid.device):
        raise ValueError("query, slab and slab_valid must share a device")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chunking(n_qtiles: int, W: int, block_rows: int, device) -> Tuple[int, int]:
    """Slab chunk size (a multiple of the kernel's row tile) giving about
    one block per SM over the (query tile, chunk) grid."""
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    max_chunks = -(-W // block_rows)
    n_chunks = max(1, min(max_chunks, -(-sms // n_qtiles)))
    chunk_rows = -(-(-(-W // n_chunks)) // block_rows) * block_rows
    return chunk_rows, -(-W // chunk_rows)


def knn2(query: torch.Tensor, slab: torch.Tensor,
         slab_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q,256) int8, slab (W,256) int8, slab_valid (W,) bool ->
    (dists (Q,2) f32 ascending, idx (Q,2) int32)."""
    _check(query, slab, slab_valid)
    if query.device.type == "cpu":
        return knn2_reference(query, slab, slab_valid)
    if query.device.type != "cuda":
        raise RuntimeError(f"knn2 runs on CPU or CUDA tensors, not {query.device}")
    for name, t in (("query", query), ("slab", slab), ("slab_valid", slab_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    Q, W = query.shape[0], slab.shape[0]
    dev = query.device
    dists = torch.empty((Q, 2), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, 2), dtype=torch.int32, device=dev)
    if Q == 0:
        return dists, idx
    lib = _library()
    n_qtiles = -(-Q // lib.vocab_knn2_block_queries())
    chunk_rows, n_chunks = _chunking(n_qtiles, W, lib.vocab_knn2_block_rows(), dev)
    scratch = torch.empty((Q, n_chunks, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vocab_knn2(query.data_ptr(), slab.data_ptr(),
                             slab_valid.data_ptr(), Q, W, chunk_rows, n_chunks,
                             scratch.data_ptr(), dists.data_ptr(),
                             idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("vocab_knn2 launch failed: "
                           + lib.vocab_knn2_error_string(err).decode())
    knn2.launches += 1
    return dists, idx


knn2.launches = 0

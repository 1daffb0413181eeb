"""Least H100 times of the repository's two TPU kernels at the shapes their
callers give them, from bytes moved and operations done.

K1, the vocabulary 2-NN (``rtabmap_tpu/ops/pallas/vocab_knn.py::pallas_knn2``),
at the appearance-only tick's shape: Q=400 descriptors of 256 int8 against
the whole 262144-word slab, every word valid (the most work the shape can
need), int8 tensor-core rate.

K2, the 3-D 1-NN of ICP (``rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d``),
at the shapes of ``rtabmap_tpu/ops/icp.py``: one search per ICP iteration
plus the final one (``Icp/Iterations`` 30 -> 31 searches a call); the
destination is the scan-odometry local map (``OdomF2M/ScanMaxSize`` 2000
rounded up to 2048, ``odometry/scan_f2m.py:176``) and the query a scan of
as many points. Each pair costs 3 subtractions, 3 multiplications and 2
additions in float32 on the CUDA cores (the kernel takes direct
differences, not a product the tensor cores could run).

Usage (from the repository root): PYTHONPATH=. python scripts/kernel_bounds.py
"""
from __future__ import annotations

import json

from chip_smoke import HBM_BYTES_PER_S, INT8_OPS_PER_S

F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def bound_us(bytes_: float, ops: float, ops_per_s: float) -> dict:
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bytes": bytes_, "ops": ops, "bound_us": max(t_bytes, t_ops) * 1e6,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1(Q: int = 400, W: int = 262144, D: int = 256) -> dict:
    return {"kernel": "vocab_knn2", "Q": Q, "W": W,
            **bound_us(Q * D + W * D + W + Q * 2 * 8, 2.0 * Q * W * D, INT8_OPS_PER_S)}


def k2(Q: int = 2048, N: int = 2048, searches: int = 31) -> dict:
    one = bound_us(3 * 4 * Q + 3 * 4 * N + N + Q * 8, 8.0 * Q * N, F32_OPS_PER_S)
    return {"kernel": "nn3d", "Q": Q, "N": N, **one,
            "searches_per_icp": searches, "icp_bound_us": one["bound_us"] * searches}


if __name__ == "__main__":
    for row in (k1(), k2(), k2(8192, 8192)):
        print(json.dumps(row))

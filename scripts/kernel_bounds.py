"""Least H100 times of the repository's two TPU kernels at the shapes their
callers give them, from bytes moved and operations done, by the bound
functions ``chip_smoke.py`` uses (``knn2_bound_ms``, ``nn3d_bound_ms``).

K1, the vocabulary 2-NN (``rtabmap_tpu/ops/pallas/vocab_knn.py::pallas_knn2``):
Q=400 descriptors of 256 int8 against the dictionary's valid prefix at the
BOW cell's end state (31853 words), against the whole 262144-word slab with
every word valid (the most work the shape can need), and with 70% valid.

K2, the 3-D 1-NN of ICP (``rtabmap_tpu/ops/pallas/nn3d.py::pallas_nn3d``),
at the LiDAR path's shapes (``Icp/Iterations`` 15 -> 16 searches an ICP
call): a 28800-point VLP-16 scan against the 16384-point full-width local
map (odometry) and against another scan (closure registration). The
queries are the scan's points that survive its 5 cm voxel filter, and so
are the closure's destination points: ``chip_smoke.py`` prints 12145 and
12736 for its two scans, and 12145 stands for both here (its own bounds
use the counts of its inputs). The unmasked rows count every query, as
the search did before it took a query mask.

Usage (from the repository root): PYTHONPATH=. python scripts/kernel_bounds.py
"""
from __future__ import annotations

import json

from chip_smoke import knn2_bound_ms, nn3d_bound_ms

SCAN = 16 * 1800          # VLP-16 points a scan
MAP = 16384               # full-width local map (tools/lidar_mapping.py)
VOXEL_KEPT = 12145        # scan points kept by the 5 cm voxel filter
SEARCHES = 16             # Icp/Iterations 15, plus the final search


def row(kernel: str, case: str, bound) -> dict:
    ms, by = bound
    return {"kernel": kernel, "case": case, "bound_us": ms * 1e3, "bound_by": by}


def rows() -> list:
    out = [row("vocab_knn2", "Q=400 x prefix 31853", knn2_bound_ms(400, 31853, 31853)),
           row("vocab_knn2", "Q=400 x 262144 all valid", knn2_bound_ms(400, 262144, 262144)),
           row("vocab_knn2", "Q=400 x 262144 70% valid",
               knn2_bound_ms(400, 262144, int(0.7 * 262144)))]
    for case, (Q, N, nq, np_) in {
            "odometry masked": (SCAN, MAP, VOXEL_KEPT, MAP),
            "closure masked": (SCAN, SCAN, VOXEL_KEPT, VOXEL_KEPT),
            "odometry unmasked": (SCAN, MAP, SCAN, MAP),
            "closure unmasked": (SCAN, SCAN, SCAN, VOXEL_KEPT)}.items():
        r = row("nn3d", f"{case}: {nq} of {Q} queries x {np_} of {N} points",
                nn3d_bound_ms(Q, N, nq, np_))
        r["per_icp_us"] = r["bound_us"] * SEARCHES
        out.append(r)
    return out


if __name__ == "__main__":
    for r in rows():
        print(json.dumps(r))

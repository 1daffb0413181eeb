"""Time the RGB-D + LiDAR path's global scan-map registration on a card.

The inputs are ``chip_smoke.py``'s ``global-scan-map`` case: a VLP-16 scan
of the localization sequence (28,800 points) against the 4,194,304-row slab
of the full-width sequence's 130 scans (at most 65,536 valid after the
5 cm voxel hash). A run is one ``register_scans`` call as the engine's
``_localize_global_scan`` makes it (the slab's normals, 31 K2 searches and
one K2 compaction), ended by a host read, timed by the host clock. Prints
one JSON line: the card, each run's ms and their median, and K2's
compaction alone (one eager call and CUDA-graph device time, as
``chip_smoke.py`` times it) on the slab and on the LiDAR odometry plan
(``chip_smoke.py``'s ``odometry-masked`` case: 16,384 points and 28,800
query flags), there both in its one launch and with the count pass forced
(``COMPACT_ONE_PASS_TILES`` set to 0, as a plan of more tiles runs).
``--runs 0`` times the compactions only.

    PYTHONPATH=. python scripts/global_scan_registration.py [--runs 10]

To compare two trees, run it from each in turn on one card: parent,
change, change, parent.
"""
import argparse
import json
import time

import numpy as np
import torch

from chip_smoke import card_line, graph_ms, nn3d_cases, time_ms
from rtabmap_tpu_torch.ops.cuda import build
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from rtabmap_tpu_torch.ops.icp import register_scans


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all([K2.SOURCE])
    cases = {c[0]: c[1:] for c in nn3d_cases()}
    src, dst, valid, src_valid = cases["global-scan-map"]
    guess = torch.eye(4, device=src.device)

    def register():
        res, _ = register_scans(src, src_valid, dst, valid, guess=guess, voxel=0.0)
        return res.transform.cpu()

    for _ in range(args.warmup if args.runs else 0):
        register()
    ms = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register()
        ms.append((time.perf_counter() - t0) * 1e3)
    prepare = lambda: K2.nn3d_prepare(dst, valid, src_valid)  # noqa: E731
    _, o_dst, o_valid, o_src_valid = cases["odometry-masked"]
    odometry = lambda: K2.nn3d_prepare(o_dst, o_valid, o_src_valid)  # noqa: E731
    one_pass = K2.COMPACT_ONE_PASS_TILES
    K2.COMPACT_ONE_PASS_TILES = 0
    try:
        two_pass = graph_ms(odometry)
    finally:
        K2.COMPACT_ONE_PASS_TILES = one_pass
    print(json.dumps({"card": card_line(), "rows": dst.shape[0],
                      "valid_points": int(valid.sum()), "runs_ms": ms,
                      "median_ms": float(np.median(ms)) if ms else None,
                      "compact_ms": time_ms(prepare), "compact_graph_ms": graph_ms(prepare),
                      "odometry_compact_ms": time_ms(odometry),
                      "odometry_compact_graph_ms": graph_ms(odometry),
                      "odometry_compact_two_pass_graph_ms": two_pass}),
          flush=True)


if __name__ == "__main__":
    main()

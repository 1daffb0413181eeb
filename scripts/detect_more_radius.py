"""Time ``detect_more_loop_closures`` at several sweep radii on one store.

Builds the full-width mapping session's store on the card as
``chip_smoke.py`` does (``mapping_session``), then on a copy of it for each
radius resumes the engine and runs the sweep, printing one JSON line a
radius: closures added, graph solves, seconds, the map ATE before and
after and their ratio (``chip_smoke.py``'s map_tools check holds it to
1.1). ``chip_smoke.py``'s ``MT_RADIUS`` was chosen from these lines.

Usage (from the repository root, on a machine with a CUDA card):
    python3 scripts/detect_more_radius.py [--radii 0.5 0.75 1.0]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from rtabmap_tpu_torch.geometry import camera as C  # noqa: E402
from rtabmap_tpu_torch.memory.db import Database  # noqa: E402
from rtabmap_tpu_torch.ops.cuda import build  # noqa: E402
from rtabmap_tpu_torch.tools import rgbd_sessions  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--radii", type=float, nargs="+", default=[0.5, 0.75, 1.0])
    args = ap.parse_args()
    build.build_all([CS.K1.SOURCE, CS.K2.SOURCE])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        t = time.perf_counter()
        CS.mapping_session(path)
        print(json.dumps({"mapping_s": time.perf_counter() - t}), flush=True)
        db = Database(path)
        cam = C.CameraModel.make(*db.load_admin()["parameters"]["__camera__"])
        db.close()
        for r in args.radii:
            copy = os.path.join(tmp, f"sweep{r}.db")
            shutil.copy(path, copy)
            slam, db = CS._resume(copy, cam, dev)
            ate0, _ = rgbd_sessions.map_ate(slam)
            n0 = len(slam.solves)
            t = time.perf_counter()
            added = slam.detect_more_loop_closures(cluster_radius=r)
            s = time.perf_counter() - t
            ate1, _ = rgbd_sessions.map_ate(slam)
            print(json.dumps({"radius": r, "added": added, "solves": len(slam.solves) - n0,
                              "s": s, "ate_before": ate0, "ate_after": ate1,
                              "ratio": ate1 / ate0}), flush=True)
            db.close()


if __name__ == "__main__":
    main()

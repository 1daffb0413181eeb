"""Reference run of the JAX package's ``detect_more_loop_closures`` on a map
store, with the LM iterations of every graph solve it makes.

Loads the store with the JAX engine on the CPU (``Rtabmap.load``, no new
session; the camera from the store's ``__camera__`` parameter, which the
port's engine writes) and runs ``detect_more_loop_closures`` at the given
radius, recording each ``_solve_padded`` call: (nodes, LM iterations run,
of Optimizer/Iterations' budget of 100). Prints one JSON line. The port's
counterpart on the same store: ``scripts/global_ba_study.py --mapping-only
--detect-radii R --keep DIR`` writes ``DIR/mapping.db`` and prints the
port's iterations.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_detect_iterations.py STORE [--radius 0.3]
        [--node-capacity 1024] [--words 512]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("store")
    ap.add_argument("--radius", type=float, default=0.3)
    ap.add_argument("--node-capacity", type=int, default=1024)
    ap.add_argument("--words", type=int, default=512)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.memory.db import Database
    from rtabmap_tpu.utils.params import Parameters

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detect.db")
        shutil.copyfile(args.store, path)
        db = Database(path)
        cam = C.CameraModel.make(*db.load_admin()["parameters"]["__camera__"])
        slam = Rtabmap.load(db, cam, Parameters(), node_capacity=args.node_capacity,
                            words_per_frame=args.words, new_session=False)
        solves = []
        solve = slam._solve_padded

        def counted(poses, *a, **k):
            out = solve(poses, *a, **k)
            solves.append((int(np.asarray(poses).shape[0]), int(out[2])))
            return out
        slam._solve_padded = counted
        added = slam.detect_more_loop_closures(cluster_radius=args.radius)
        db.close()
    iters = [i for _, i in solves]
    print(json.dumps({"store": os.path.basename(args.store), "radius": args.radius,
                      "added": added, "solves": len(solves),
                      "iterations": iters, "at_budget": sum(i >= 100 for i in iters),
                      "nodes": [n for n, _ in solves]}))


if __name__ == "__main__":
    main()

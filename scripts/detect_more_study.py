"""``detect_more_loop_closures`` on fresh mapping stores: the map ATE it
leaves against the map ATE before.

Runs the mapping session of ``tools/rgbd_sessions.py`` ``--maps`` times
(full width on the card by default; each run's store differs, since the
card's RANSAC and sums run in another order), then on each store the sweep
at ``--radius`` as ``chip_smoke.py``'s map_tools phase runs it, and prints
one JSON line a store: the map ATE as stored; as stored and solved whole
once; after the sweep's incremental solves (read just before the sweep's
closing full-graph solve); after the sweep; the closures added and the
closing solve's iterations. Then, on the sweep's graph, a whole-graph solve
taken whatever its error (ATE, worst edge-error ratio against the
RGBD/OptimizeMaxError gate), and the same after removing the sweep's
closure with the largest error until the solve passes the gate.
``--full-gate`` also runs the sweep with Tpu/IncrementalOptimization off
(each closure gated on a whole-graph solve).

Usage: python scripts/detect_more_study.py [--device cpu --frames N --size W H]
       [--maps 3] [--radius 1.0] [--full-gate]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtabmap_tpu_torch.device import resolve_device  # noqa: E402
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap  # noqa: E402
from rtabmap_tpu_torch.geometry import camera as C  # noqa: E402
from rtabmap_tpu_torch.memory.db import Database  # noqa: E402
from rtabmap_tpu_torch.memory.memory import LINK_USER_CLOSURE  # noqa: E402
from rtabmap_tpu_torch.optim import pose_graph as PG  # noqa: E402
from rtabmap_tpu_torch.tools import rgbd_laps, rgbd_sessions  # noqa: E402
from rtabmap_tpu_torch.utils import metrics  # noqa: E402
from rtabmap_tpu_torch.utils.logging import Statistics  # noqa: E402
from rtabmap_tpu_torch.utils.params import Parameters  # noqa: E402


def resume(path, cam, dev):
    spec = rgbd_laps.sequence_spec("full")
    db = Database(path)
    return Rtabmap.load(db, cam, Parameters(), node_capacity=spec["node_capacity"],
                        words_per_frame=spec["max_kp"], new_session=False, device=dev), db


def whole_solve(slam):
    """(ATE, worst edge-error ratio, the solve's graph) of one solve of
    the whole graph from the optimized poses; the engine's poses stay."""
    ids, poses, ef, et, meas, info, switch, priors = slam._build_graph()
    n_reg = sum(1 for i in ids if i >= 0)
    out, _chi2, _iters, max_err, _diag = slam._solve_padded(
        poses, ef, et, meas, info, switch, priors, root_idx=0)
    new = out.poses.cpu().numpy()
    keep = [k for k in range(n_reg) if slam.memory.get(ids[k]).gt_pose is not None]
    ate = metrics.ate_rmse(new[keep], np.stack([slam.memory.get(ids[k]).gt_pose
                                                 for k in keep]))
    return ate, float(max_err), (ids, ef, et, out)


def repair_added(slam, limit: int = 200):
    """Remove the sweep's closure with the largest error until a whole
    solve passes the gate; (removed, ATE, worst ratio)."""
    removed = 0
    while True:
        ate, max_err, (ids, ef, et, out) = whole_solve(slam)
        if max_err <= slam.max_error or removed >= limit:
            return removed, ate, max_err
        lin, ang = (x.cpu().numpy() for x in PG.edge_errors(out))
        err = np.maximum(lin, ang)[: len(ef)]
        for e in np.argsort(-err):
            a, b = ids[int(ef[e])], ids[int(et[e])]
            lk = slam.memory.get(a).links.get(b)
            if lk is not None and lk.type == LINK_USER_CLOSURE:
                slam.memory.remove_link(a, b)
                removed += 1
                break
        else:
            return removed, ate, max_err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--maps", type=int, default=3)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--full-gate", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cam = C.CameraModel.make(*rgbd_sessions.camera(tuple(args.size)))
    with tempfile.TemporaryDirectory() as tmp:
        for m in range(args.maps):
            path = os.path.join(tmp, f"mapping{m}.db")
            for _ in rgbd_sessions.iter_sessions(path, dev, frames=args.frames,
                                                 size=tuple(args.size), sessions=("mapping",)):
                pass
            row = {"map": m}
            slam, db = resume(path, cam, dev)
            row["ate_stored"] = rgbd_sessions.map_ate(slam)[0]
            slam._optimize_full(Statistics(), [])
            row["ate_stored_solved_whole"] = rgbd_sessions.map_ate(slam)[0]
            db.close()

            slam, db = resume(path, cam, dev)
            closing = slam._optimize_full

            def before_closing(st, new_links, slam=slam, closing=closing):
                if not new_links:   # the sweep's closing solve
                    row["ate_incremental"] = rgbd_sessions.map_ate(slam)[0]
                return closing(st, new_links)
            slam._optimize_full = before_closing
            t0 = time.perf_counter()
            row["added"] = slam.detect_more_loop_closures(cluster_radius=args.radius)
            row["s"] = time.perf_counter() - t0
            row["ate_after"] = rgbd_sessions.map_ate(slam)[0]
            row["closing_solve_iterations"] = slam.solves[-1][1]
            row["ratio_after"] = row["ate_after"] / row["ate_stored"]
            if "ate_incremental" in row:
                row["ratio_incremental"] = row["ate_incremental"] / row["ate_stored"]
            row["gate"] = slam.max_error
            row["ate_whole"], row["whole_error_ratio"], _ = whole_solve(slam)
            (row["repair_removed"], row["ate_repaired"],
             row["repaired_error_ratio"]) = repair_added(slam)
            db.close()
            if args.full_gate:
                slam, db = resume(path, cam, dev)
                slam.incremental_optimization = False
                t0 = time.perf_counter()
                row["full_gate_added"] = slam.detect_more_loop_closures(
                    cluster_radius=args.radius)
                row["full_gate_s"] = time.perf_counter() - t0
                row["full_gate_ate_after"] = rgbd_sessions.map_ate(slam)[0]
                row["full_gate_ratio_after"] = row["full_gate_ate_after"] / row["ate_stored"]
                db.close()
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

"""The global bundle adjustment on the sessions' maps, and the rotations
off SO(3) that the maps hold.

Builds the mapping and resumed stores as ``tools/rgbd_sessions.py`` does
(full width on the card by default) and prints one JSON line each for:
how far the odometry and optimized rotations sit off SO(3) (|R^T R - I|);
the map ATE after inverting the stored poses twice by the transpose; and
the global BA of the resumed store as the engine runs it (rotations
projected onto SO(3), ``bundle_adjust_large``), by the dense solve, with
30 LM iterations, with a 0.05 m track tolerance and with the rotations
kept as they are (the twin's problem), each with its map ATE before and
after. ``--keep DIR`` keeps the mapping and resumed stores there (for
``scripts/jax_global_ba.py``, the JAX twin on the same store). ``--orthonormal-odometry`` first projects every odometry
pose the engine takes onto SO(3) (a fix to queue, not the port's path).
``--detect-radii`` times ``detect_more_loop_closures`` on the mapping store;
``--mapping-only`` runs the mapping session and those sweeps alone.

Usage: python scripts/global_ba_study.py [--device cpu --frames N --size W H]
       [--orthonormal-odometry] [--detect-radii 0.15 0.3] [--mapping-only] [--keep DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtabmap_tpu_torch.device import resolve_device  # noqa: E402
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap  # noqa: E402
from rtabmap_tpu_torch.geometry import camera as C  # noqa: E402
from rtabmap_tpu_torch.geometry import transform as T  # noqa: E402
from rtabmap_tpu_torch.memory.db import Database  # noqa: E402
from rtabmap_tpu_torch.optim import ba as BA  # noqa: E402
from rtabmap_tpu_torch.tools import rgbd_laps, rgbd_sessions  # noqa: E402
from rtabmap_tpu_torch.utils import metrics  # noqa: E402
from rtabmap_tpu_torch.utils.params import Parameters  # noqa: E402


def off_so3(P) -> float:
    R = np.asarray(P, np.float64)[:, :3]
    return float(np.abs(R.T @ R - np.eye(3)).max())


def resume(path, cam, dev):
    spec = rgbd_laps.sequence_spec("full")
    db = Database(path)
    return Rtabmap.load(db, cam, Parameters(), node_capacity=spec["node_capacity"],
                        words_per_frame=spec["max_kp"], new_session=False, device=dev), db


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--orthonormal-odometry", action="store_true")
    ap.add_argument("--detect-radii", type=float, nargs="*", default=[])
    ap.add_argument("--keep", default=None, help="directory to keep the stores in")
    ap.add_argument("--mapping-only", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.orthonormal_odometry:
        process = Rtabmap.process

        def projected(self, frame, odom_pose, *a, **k):
            P = T.orthonormalize(torch.from_numpy(np.array(odom_pose, np.float32)))
            return process(self, frame, P.numpy(), *a, **k)
        Rtabmap.process = projected
    cam = C.CameraModel.make(*rgbd_sessions.camera(tuple(args.size)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        for res in rgbd_sessions.iter_sessions(path, dev, frames=args.frames,
                                               size=tuple(args.size),
                                               sessions=("mapping",) if args.mapping_only
                                               else ("mapping", "resume")):
            run = res.pop("run")
            print(json.dumps({k: res[k] for k in ("session", "nodes", "loops", "map_ate")}),
                  flush=True)
            shutil.copyfile(path, os.path.join(tmp, res["session"] + ".db"))
            if args.keep:
                os.makedirs(args.keep, exist_ok=True)
                shutil.copyfile(path, os.path.join(args.keep, res["session"] + ".db"))
        for r in args.detect_radii:
            p = os.path.join(tmp, "detect.db")
            shutil.copyfile(os.path.join(tmp, "mapping.db"), p)
            slam, db = resume(p, cam, dev)
            n0, ate0 = len(slam.solves), rgbd_sessions.map_ate(slam)[0]
            t0 = time.perf_counter()
            added = slam.detect_more_loop_closures(cluster_radius=r)
            solves = [s[2] for s in slam.solves[n0:]]
            iters = [s[1] for s in slam.solves[n0:]]
            print(json.dumps({"detect_radius": r, "added": added,
                              "s": time.perf_counter() - t0, "solves": len(solves),
                              "solve_ms_median": float(np.median(solves)) if solves else None,
                              "iters_median": float(np.median(iters)) if iters else None,
                              "iterations": iters,
                              "iters_at_budget": sum(i >= slam.optimizer_iterations
                                                     for i in iters),
                              "ate_before": ate0, "ate_after": rgbd_sessions.map_ate(slam)[0]}),
                  flush=True)
            db.close()
        if args.mapping_only:
            return
        p = os.path.join(tmp, "ba.db")
        shutil.copyfile(os.path.join(tmp, "resume.db"), p)
        slam, db = resume(p, cam, dev)
        opt = slam.get_optimized_poses()
        odo = [off_so3(s.pose) for s in slam.memory.signatures.values()]
        rot = [off_so3(P) for P in opt.values()]
        ids = sorted(opt)
        gt = np.stack([slam.memory.get(i).gt_pose for i in ids])
        stored = torch.from_numpy(np.stack([np.asarray(opt[i], np.float32) for i in ids]))
        print(json.dumps({
            "odometry_off_so3_max": max(odo), "odometry_past_1e-3": sum(v > 1e-3 for v in odo),
            "optimized_off_so3_max": max(rot), "optimized_past_1e-3": sum(v > 1e-3 for v in rot),
            "nodes": len(rot), "map_ate": metrics.ate_rmse(stored.numpy(), gt),
            "map_ate_after_inverting_twice": metrics.ate_rmse(
                T.inverse(T.inverse(stored)).numpy(), gt)}), flush=True)
        fx = cam.fx
        large = lambda q: BA.bundle_adjust_large(q, huber=4.0 / fx)  # noqa: E731
        for name, tol, orth, solve in (
                ("engine", 0.10, True, large),
                ("dense", 0.10, True, lambda q: BA.bundle_adjust(q, huber=4.0 / fx)),
                ("large_30_iterations", 0.10, True,
                 lambda q: BA.bundle_adjust_large(q, iters=30, huber=4.0 / fx)),
                ("track_tolerance_0.05", 0.05, True, large),
                ("rotations_as_stored", 0.10, False, large)):
            ids, n_tracks, prob = slam.global_ba_problem(track_tolerance=tol,
                                                         orthonormalize=orth)
            gt = np.stack([slam.memory.get(i).gt_pose for i in ids])
            t0 = time.perf_counter()
            out, cost = solve(prob)
            new = T.inverse(out.poses).cpu().numpy()
            print(json.dumps({"ba": name, "cameras": len(ids), "tracks": n_tracks,
                              "s": time.perf_counter() - t0,
                              "cost_before": float(BA._cost(prob, prob.poses, prob.points,
                                                            4.0 / fx)),
                              "cost_after": float(cost),
                              "ate_before": metrics.ate_rmse(T.inverse(prob.poses).cpu().numpy(),
                                                             gt),
                              "ate_after": metrics.ate_rmse(new, gt)}), flush=True)
        db.close()


if __name__ == "__main__":
    main()

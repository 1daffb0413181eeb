"""Reference run of the JAX package's global bundle adjustment on a map store.

Loads the store with the JAX engine on the CPU (``Rtabmap.load``, no new
session) and runs its ``global_bundle_adjustment`` twice on fresh loads:
with the optimized poses as stored, and with their rotations first
projected onto SO(3) (the SVD's nearest rotation, as the port's
``global_ba_problem`` does). Prints one JSON line each: cameras, tracks,
the path the twin takes (``bundle_adjust_large`` past 600,000 cameras x
tracks), how far the rotations sit off SO(3), and the map ATE (SE(3)-aligned
translation RMSE against the nodes' ground truth) before and after.

The stores: ``scripts/global_ba_study.py --keep DIR`` writes the port's
mapping and resumed stores of ``tools/rgbd_sessions.py``; the camera is the
store's ``__camera__`` parameter, else ``--cam``.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_global_ba.py STORE [--cam fx,fy,cx,cy,w,h]
        [--node-capacity 1024] [--words 512]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def _off_so3(P) -> float:
    import numpy as np

    R = np.asarray(P, np.float64)[:, :3]
    return float(np.abs(R.T @ R - np.eye(3)).max())


def _project(P):
    import numpy as np

    P = np.asarray(P, np.float64)
    U, _, Vt = np.linalg.svd(P[:, :3])
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    return np.concatenate([U @ D @ Vt, P[:, 3:]], axis=1).astype(np.float32)


def run(store: str, cam_vals, node_capacity: int, words: int, project: bool) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.memory.db import Database
    from rtabmap_tpu.utils import metrics
    from rtabmap_tpu.utils.params import Parameters

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ba.db")
        shutil.copyfile(store, path)
        db = Database(path)
        stored = db.load_admin()["parameters"]
        vals = cam_vals or stored.get("__camera__")
        if not vals:
            raise SystemExit("the store names no camera: pass --cam fx,fy,cx,cy,w,h")
        cam = C.CameraModel.make(*vals)
        slam = Rtabmap.load(db, cam, Parameters(), node_capacity=node_capacity,
                            words_per_frame=words, new_session=False)
        if project:
            for i in list(slam.optimized_poses):
                slam.optimized_poses[i] = _project(slam.optimized_poses[i])

        def ate():
            ids = [i for i in sorted(slam.optimized_poses) if i >= 0
                   and (s := slam.memory.get(i)) is not None and s.gt_pose is not None]
            est = np.stack([np.asarray(slam.optimized_poses[i]) for i in ids])
            gt = np.stack([slam.memory.get(i).gt_pose for i in ids])
            return metrics.ate_rmse(est, gt), len(ids)

        ids = [i for i in sorted(slam.memory.signatures)
               if (s := slam.memory.get(i)) is not None and s.word_ids is not None
               and i in slam.optimized_poses]
        off = max(_off_so3(slam.optimized_poses[i]) for i in ids)
        ate0, n = ate()
        # the twin's path and sizes: count its tracks by wrapping both solvers
        import rtabmap_tpu.optim.ba as BA

        seen, kept = {}, {n: getattr(BA, n) for n in ("bundle_adjust", "bundle_adjust_large")}
        for name in kept:
            orig = getattr(BA, name)

            def wrapped(prob, *a, _orig=orig, _name=name, **k):
                seen.update(path=_name, cameras=int(prob.poses.shape[0]),
                            tracks=int(prob.points.shape[0]),
                            observations=int(prob.uv.shape[0]))
                out, cost = _orig(prob, *a, **k)
                seen["cost_after"] = float(cost)
                return out, cost
            setattr(BA, name, wrapped)
        t0 = time.perf_counter()
        try:
            ok = slam.global_bundle_adjustment()
        finally:
            for name, fn in kept.items():
                setattr(BA, name, fn)
        s = time.perf_counter() - t0
        ate1, _ = ate()
        db.close()
    return {"store": os.path.basename(store), "rotations": "projected" if project else "as stored",
            "ok": bool(ok), **seen, "rotations_max_off_so3": off, "ate_nodes": n,
            "ate_before": ate0, "ate_after": ate1, "ate_ratio": ate1 / ate0, "s": s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("store")
    ap.add_argument("--cam", default=None, help="fx,fy,cx,cy,w,h")
    ap.add_argument("--node-capacity", type=int, default=1024)
    ap.add_argument("--words", type=int, default=512)
    args = ap.parse_args(argv)
    cam = None
    if args.cam:
        fx, fy, cx, cy, w, h = (float(x) for x in args.cam.split(","))
        cam = (fx, fy, cx, cy, int(w), int(h))
    for project in (False, True):
        print(json.dumps(run(args.store, cam, args.node_capacity, args.words, project)),
              flush=True)


if __name__ == "__main__":
    main()

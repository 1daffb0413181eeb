"""Reference run of the JAX package for the port's multi-session checks.

Renders the three sessions of ``rtabmap_tpu_torch/tools/rgbd_sessions.py``
(map, resume, localize against one store, 640x480) with the JAX renderer
and runs them through the JAX package on the CPU: ``run_dataset`` into a
fresh ``Database``, then ``Rtabmap.load`` of the store for the resumed
session and, with ``Mem/IncrementalMemory`` false, for the localization
session (``run_dataset`` continues the loaded engine); the mapping
session ends with ``repair_graph()``, as ``tools/rgbd_sessions.py`` does.
Prints one JSON line per session: frames, lost frames, loop closures,
proximity and inter-session links, nodes, the map's SLAM ATE, the PCG
solves (padded graphs past 400 nodes) and, for localization, the
localized frames and their errors. ``chip_smoke.py`` takes its thresholds from the lowest
counts over seeds 0-3 (the RANSAC draws differ between the packages).

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_rgbd_sessions.py [--seed S] [--frames N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time


def _seed_engines(seed: int):
    """Shift the RANSAC keys of the JAX odometry (seed) and engine (42 +
    seed) as ``run_dataset(seed=...)`` does in the port."""
    import functools

    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.odometry.f2m import OdometryF2M

    for cls, value in ((OdometryF2M, seed), (Rtabmap, 42 + seed)):
        cls.__init__ = functools.partialmethod(cls.__init__, seed=value)


@contextlib.contextmanager
def _engine_for_run_dataset(slam):
    """The JAX ``run_dataset`` builds its own engine; hand it ``slam``."""
    import rtabmap_tpu.engine.rtabmap as E

    made = E.Rtabmap
    E.Rtabmap = lambda *a, **k: slam
    try:
        yield
    finally:
        E.Rtabmap = made


@contextlib.contextmanager
def _count_pcg(log):
    """Record the node count of every ``optimize_pcg`` call."""
    import rtabmap_tpu.optim.pose_graph as PG

    pcg = PG.optimize_pcg

    def counted(g, *a, **k):
        log.append(int(g.poses.shape[0]))
        return pcg(g, *a, **k)

    PG.optimize_pcg = counted
    try:
        yield
    finally:
        PG.optimize_pcg = pcg


def run(seed: int = 0, frames: int = 0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.datasets.readers import Frame
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.memory.db import Database
    from rtabmap_tpu.tools.dataset_runner import run_dataset
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools import rgbd_sessions as S
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    spec = sequence_spec("full")
    cam = C.CameraModel.make(*S.camera())
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    rfn = jax.jit(lambda pose: render(pose, cam, world))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        for name in S.SESSIONS:
            poses = S.session_poses(name)[: frames or None]

            def stream(poses=poses):
                for i, pose in enumerate(poses):
                    gray, depth = rfn(pose)
                    yield Frame(stamp=float(i), gray=np.asarray(gray), depth=np.asarray(depth),
                                gt_pose=np.asarray(pose))

            t0 = time.time()
            p = Parameters(S.session_params(name))
            db = Database(path)
            slam = n_stored = None
            if name != "mapping":
                slam = Rtabmap.load(db, cam, p, node_capacity=spec["node_capacity"],
                                    words_per_frame=spec["max_kp"])
                n_stored = len(slam.memory.signatures)
            pcg_nodes = []
            with _count_pcg(pcg_nodes), (_engine_for_run_dataset(slam) if slam is not None
                                         else contextlib.nullcontext()):
                out = run_dataset(stream(), cam, p, max_kp=spec["max_kp"],
                                  node_capacity=spec["node_capacity"], db=db, verbose=False)
            slam = out["slam"]
            repaired = slam.repair_graph() if name == "mapping" else []
            hist = slam.stats_history[-out["frames"]:]
            ate, ate_nodes = S.map_ate(slam)
            res = {"session": name, "seed": seed, "frames": out["frames"], "lost": out["lost"],
                   "loops": out["loops"],
                   "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
                   "inter_session_links": S.inter_session_links(slam),
                   "nodes": len(slam.memory.signatures), "stored_nodes": n_stored or 0,
                   "wm": len(slam.memory.wm), "map_ate": ate, "map_ate_nodes": ate_nodes,
                   "pcg_solves": len(pcg_nodes), "pcg_nodes": sorted(set(pcg_nodes)),
                   "n_words": slam.memory.vocab.n_words,
                   "repaired_links": [list(lk) for lk in repaired]}
            if not slam.memory.incremental:
                errs = S.localization_errors(slam, hist, poses)
                res.update(localized=len(errs),
                           loc_err_min_m=float(min(errs)) if errs else None,
                           loc_err_median_m=float(np.median(errs)) if errs else None)
            slam.close()
            db.close()
            res["seconds"] = round(time.time() - t0, 1)
            print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC keys")
    ap.add_argument("--frames", type=int, default=0, help="cut each session (0 = whole)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.seed:
        _seed_engines(args.seed)
    run(args.seed, args.frames)


if __name__ == "__main__":
    main()

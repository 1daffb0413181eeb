"""Reference run of the JAX package for the port's navigation checks.

Builds the mapping session of ``rtabmap_tpu_torch/tools/rgbd_sessions.py``
(two 60-frame laps at 640x480) into a fresh store with the JAX package on
the CPU (``run_dataset``, then ``repair_graph()`` and ``close()``), labels
``dock`` and ``desk`` with the JAX store tool (``db_edit set_label``), and
runs the drive of ``rtabmap_tpu_torch/tools/navigation.py`` on a copy of
the store for each mode: ``Rtabmap.load`` with the mode's parameters
(``localization``, the port's drive: ``Mem/IncrementalMemory`` false;
``resume``: a new mapping session; both with the port's
``Rtabmap/MemoryThr``),
lap 1 from frame 30 back to frame 0 through ``run_dataset`` (which
continues the loaded engine), the goal sent by ``GoalTracker`` as soon as
``compute_path`` reaches ``dock``. Prints one JSON line a mode: frames to
goal, the frame the goal was sent at, path length, the ticks that paged a
node back from the store and those that paged a path node with no
hypothesis accepted, the final status, virtual links left and whether the
current goal kept its order along the path. ``chip_smoke.py``'s
``navigation`` phase takes its thresholds from the lowest or highest over
seeds 0-3 (the RANSAC draws differ between the packages), and its mode
from the modes that reach the goal.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_navigation.py [--seed S] [--modes M ...] [--keep DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def mode_params(mode: str):
    """The engine parameters of ``mode``: ``localization`` is the port's
    drive (``navigation.drive_params``); ``resume`` keeps mapping."""
    from rtabmap_tpu_torch.tools import navigation as N

    if mode == "localization":
        return N.drive_params()
    if mode == "resume":
        return {"Rtabmap/MemoryThr": N.MEMORY_THR}
    raise KeyError(f"unknown mode {mode!r}; use localization or resume")


def run(seed: int, modes, keep: str = ""):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import jax_rgbd_sessions as JS
    from rtabmap_tpu.datasets.readers import Frame
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.memory.db import Database
    from rtabmap_tpu.tools import cli
    from rtabmap_tpu.tools.dataset_runner import run_dataset
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools import navigation as N
    from rtabmap_tpu_torch.tools import rgbd_sessions as S
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    spec = sequence_spec("full")
    cam = C.CameraModel.make(*S.camera())
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    rfn = jax.jit(lambda pose: render(pose, cam, world))

    def stream(poses):
        for i, pose in enumerate(poses):
            gray, depth = rfn(pose)
            yield Frame(stamp=float(i), gray=np.asarray(gray), depth=np.asarray(depth),
                        gt_pose=np.asarray(pose))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        kept = os.path.join(keep, f"map_seed{seed}.db") if keep else ""
        if kept and os.path.exists(kept):
            shutil.copyfile(kept, path)
        else:
            t0 = time.time()
            db = Database(path)
            out = run_dataset(stream(S.session_poses("mapping")), cam, Parameters(),
                              max_kp=spec["max_kp"], node_capacity=spec["node_capacity"],
                              db=db, verbose=False)
            out["slam"].repair_graph()
            out["slam"].close()
            db.close()
            print(json.dumps({"seed": seed, "mapping_frames": out["frames"],
                              "mapping_loops": out["loops"], "mapping_lost": out["lost"],
                              "seconds": round(time.time() - t0, 1)}), flush=True)
            if kept:
                os.makedirs(keep, exist_ok=True)
                shutil.copyfile(path, kept)
        db = Database(path, async_writes=False)
        infos = db.node_infos()
        db.close()
        dock = N.node_for_frame(infos, N.DOCK_FRAME)
        desk = N.node_for_frame(infos, N.DESK_FRAME)
        cli.tool_db_edit([path, "set_label", str(dock), "dock"])
        cli.tool_db_edit([path, "set_label", str(desk), "desk"])
        labels = {r["id"]: r["label"] for r in cli.tool_db_edit([path, "nodes"]) if r["label"]}
        for mode in modes:
            t0 = time.time()
            copy = os.path.join(tmp, f"{mode}.db")
            shutil.copyfile(path, copy)
            p = Parameters(mode_params(mode))
            db = Database(copy)
            slam = Rtabmap.load(db, cam, p, node_capacity=spec["node_capacity"],
                                words_per_frame=spec["max_kp"], new_session=True)
            tracker = N.GoalTracker(slam, N.labelled(slam, "dock"))
            with JS._engine_for_run_dataset(slam):
                run_out = run_dataset(tracker.stream(stream(N.drive_poses())), cam, p,
                                      max_kp=spec["max_kp"],
                                      node_capacity=spec["node_capacity"], verbose=False)
            res = tracker.summary()
            ticks = res.pop("ticks")
            res.update(mode=mode, seed=seed, dock=dock, desk=desk, labels=labels,
                       lost=run_out["lost"],
                       localized=int(sum(st.get("Loop/Localized/") > 0
                                         for st in slam.stats_history)),
                       goal_ids=[t["goal_id"] for t in ticks],
                       reactivate_ids=[t["reactivate_id"] for t in ticks],
                       seconds=round(time.time() - t0, 1))
            db.close()
            print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC keys")
    ap.add_argument("--modes", nargs="+", default=["localization", "resume"],
                    choices=["localization", "resume"])
    ap.add_argument("--keep", default="", metavar="DIR",
                    help="keep the unlabelled mapping store as DIR/map_seedS.db and reuse it")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.seed:
        import jax_rgbd_sessions as JS

        JS._seed_engines(args.seed)
    run(args.seed, args.modes, args.keep)


if __name__ == "__main__":
    main()

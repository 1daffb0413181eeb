"""Localize with either package on a map either package built.

Builds the mapping and resume sessions of
``rtabmap_tpu_torch/tools/rgbd_sessions.py`` into a kept store with the
port (``--build port``, on the CPU) or the JAX package (``--build jax``),
unless the store exists, then runs the localization session on a copy of
it with the port or the JAX package and one seed each. Prints the map's
local consistency (the translation error of each node's optimized pose
relative to the next node's, and to the nearest node of the other
session, against the ground truth; the ATE) and, per localization run,
the localized frames, their errors and the frames the odometry-cache check
rejected. It separates what the map contributes to the localization
counts from what the localizing package contributes.

Usage (from the repository root; the JAX package on the CPU):
    PYTHONPATH=.:scripts python scripts/localize_stored_map.py --build port \\
        --store /tmp/port_map.db --localize port:0 port:1 jax:0
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil

import numpy as np


def build_port(path: str):
    from rtabmap_tpu_torch.tools import rgbd_sessions as S

    sessions = S.iter_sessions(path, "cpu")
    for _ in range(2):            # mapping, resume; the store is closed after each
        next(sessions).pop("run")


def build_jax(path: str):
    import jax
    import jax.numpy as jnp

    from jax_rgbd_sessions import _engine_for_run_dataset
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
    for name in ("mapping", "resume"):
        frames = [Frame(stamp=float(i), gray=np.asarray(g), depth=np.asarray(d),
                        gt_pose=np.asarray(pose))
                  for i, pose in enumerate(S.session_poses(name)) for g, d in [rfn(pose)]]
        db = Database(path)
        slam = None if name == "mapping" else Rtabmap.load(db, cam, Parameters(),
                                                           node_capacity=1024,
                                                           words_per_frame=512)
        with (_engine_for_run_dataset(slam) if slam is not None else contextlib.nullcontext()):
            out = run_dataset(frames, cam, Parameters(), max_kp=512, node_capacity=1024, db=db,
                              verbose=False)
        if name == "mapping":
            out["slam"].repair_graph()
        out["slam"].close()
        db.close()


def map_consistency(path: str) -> dict:
    from rtabmap_tpu_torch.geometry import transform as T
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.utils import metrics

    db = Database(path, async_writes=False)
    try:
        opt = db.load_admin()["optimized_poses"]
        info = {r["id"]: r for r in db.node_infos() if r["id"] in opt}
    finally:
        db.close()
    ids = sorted(info)
    gt = {i: info[i]["gt"] for i in ids}

    def off(a, b):
        return T.np_translation_norm(T.np_relative(T.np_relative(gt[a], gt[b]),
                                                   T.np_relative(opt[a], opt[b])))

    nxt = [off(a, b) for a, b in zip(ids, ids[1:]) if info[a]["map_id"] == info[b]["map_id"]]
    first = [i for i in ids if info[i]["map_id"] == 0]
    cross = [off(min(first, key=lambda a: np.linalg.norm(gt[a][:3, 3] - gt[b][:3, 3])), b)
             for b in ids if info[b]["map_id"] == 1]
    q = lambda x: [float(np.median(x)), float(np.percentile(x, 90))]  # noqa: E731
    return {"ate": metrics.ate_rmse(np.stack([opt[i] for i in ids]),
                                    np.stack([gt[i] for i in ids])),
            "next_node_m_median_p90": q(nxt), "other_session_m_median_p90": q(cross)}


def localize(path: str, pkg: str, seed: int) -> dict:
    from rtabmap_tpu_torch.tools import rgbd_sessions as S

    poses = S.session_poses("localization")
    p_over = S.session_params("localization")
    if pkg == "port":
        from rtabmap_tpu_torch.datasets.readers import Frame
        from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD, World, render_sequence
        from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
        from rtabmap_tpu_torch.geometry import camera as C
        from rtabmap_tpu_torch.memory.db import Database
        from rtabmap_tpu_torch.tools.dataset_runner import run_dataset
        from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
        from rtabmap_tpu_torch.utils.params import Parameters

        cam = C.CameraModel.make(*S.camera())
        g, d = render_sequence(poses, cam, World(sequence_spec("full")["world"],
                                                 DEFAULT_WORLD.seed), device="cpu")
        frames = [Frame(stamp=float(i), gray=g[i], depth=d[i], gt_pose=poses[i])
                  for i in range(len(poses))]
        db, p = Database(path), Parameters(p_over)
        slam = Rtabmap.load(db, cam, p, node_capacity=1024, words_per_frame=512,
                            seed=42 + seed, device="cpu")
        out = run_dataset(frames, cam, p, max_kp=512, node_capacity=1024, db=db, slam=slam,
                          verbose=False, device="cpu", seed=seed)
    else:
        import jax
        import jax.numpy as jnp

        from jax_rgbd_sessions import _engine_for_run_dataset, _seed_engines
        from rtabmap_tpu.datasets.readers import Frame
        from rtabmap_tpu.datasets.synthetic import World, render
        from rtabmap_tpu.engine.rtabmap import Rtabmap
        from rtabmap_tpu.geometry import camera as C
        from rtabmap_tpu.memory.db import Database
        from rtabmap_tpu.odometry.f2m import OdometryF2M
        from rtabmap_tpu.tools.dataset_runner import run_dataset
        from rtabmap_tpu.utils.params import Parameters
        from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

        cam = C.CameraModel.make(*S.camera())
        world = World(half_extent=jnp.asarray(sequence_spec("full")["world"], jnp.float32),
                      seed=0)
        rfn = jax.jit(lambda pose: render(pose, cam, world))
        frames = [Frame(stamp=float(i), gray=np.asarray(gg), depth=np.asarray(dd),
                        gt_pose=np.asarray(pose))
                  for i, pose in enumerate(poses) for gg, dd in [rfn(pose)]]
        inits = (OdometryF2M.__init__, Rtabmap.__init__)
        _seed_engines(seed)    # the RANSAC keys of the odometry and the engine
        try:
            db, p = Database(path), Parameters(p_over)
            slam = Rtabmap.load(db, cam, p, node_capacity=1024, words_per_frame=512)
            with _engine_for_run_dataset(slam):
                out = run_dataset(frames, cam, p, max_kp=512, node_capacity=1024, db=db,
                                  verbose=False)
        finally:
            OdometryF2M.__init__, Rtabmap.__init__ = inits
    db.close()
    hist = out["slam"].stats_history[-out["frames"]:]
    errs = S.localization_errors(out["slam"], hist, poses)
    return {"localize": pkg, "seed": seed, "localized": len(errs),
            "err_m_median": float(np.median(errs)) if errs else None,
            "rejected_frames": [k for k, st in enumerate(hist)
                                if st.get("Loop/Rejected by optimization/") > 0]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", choices=("port", "jax"), required=True)
    ap.add_argument("--store", required=True, help="kept between runs; built if absent")
    ap.add_argument("--localize", nargs="*", default=["port:0"], metavar="PKG:SEED")
    args = ap.parse_args()
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    if not os.path.exists(args.store):
        (build_port if args.build == "port" else build_jax)(args.store)
    print(json.dumps({"store": args.store, "built_by": args.build,
                      **map_consistency(args.store)}), flush=True)
    for item in args.localize:
        pkg, seed = item.split(":")
        copy = f"{args.store}.{pkg}{seed}"
        shutil.copy(args.store, copy)
        try:
            print(json.dumps(localize(copy, pkg, int(seed))), flush=True)
        finally:
            os.remove(copy)


if __name__ == "__main__":
    main()

"""Reference run of the JAX package for the port's RGB-D SLAM checks.

Renders the two sequences of ``rtabmap_tpu_torch/tools/rgbd_laps.py``
(``parity``: the sequence of ``tests/test_slam_e2e.py`` at 320x240;
``full``: two 60-frame laps at 640x480) with the JAX renderer and runs
them through the JAX package's ``run_dataset`` (``FeatureExtractor`` ->
``OdometryF2M`` -> ``Rtabmap.process``, default parameters) on the CPU.
Prints, per sequence, one JSON line: loop closures, proximity links,
lost frames, odometry and SLAM ATE. ``chip_smoke.py`` takes its
thresholds from these numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_rgbd_laps.py [--sequence parity full] [--seed S]
"""
from __future__ import annotations

import argparse
import json
import time


def _seed_engines(seed: int):
    """Shift the RANSAC keys of the JAX odometry (seed) and engine (42 +
    seed) as ``run_dataset(seed=...)`` does in the port; run_dataset in
    the JAX package builds both with their default keys."""
    import functools

    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.odometry.f2m import OdometryF2M

    for cls, value in ((OdometryF2M, seed), (Rtabmap, 42 + seed)):
        cls.__init__ = functools.partialmethod(cls.__init__, seed=value)


def run(name: str, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.datasets.readers import Frame
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.tools.dataset_runner import run_dataset
    from rtabmap_tpu.utils import metrics
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    spec = sequence_spec(name)
    W, H = spec["size"]
    cam = C.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    rfn = jax.jit(lambda pose: render(pose, cam, world))

    def frames():
        for i, pose in enumerate(spec["poses"]):
            gray, depth = rfn(pose)
            yield Frame(stamp=float(i), gray=np.asarray(gray), depth=np.asarray(depth),
                        gt_pose=np.asarray(pose))

    t0 = time.time()
    out = run_dataset(frames(), cam, Parameters(), max_kp=spec["max_kp"],
                      node_capacity=spec["node_capacity"], verbose=False)
    slam = out["slam"]
    hist = slam.stats_history
    opt = slam.get_optimized_poses()
    # each frame's node; a node the graph dropped (e.g. an earlier session
    # after a lost frame) leaves its frames out of the SLAM ATE
    have = [k for k, s in enumerate(hist) if s.ref_id in opt]
    est = np.stack([opt[hist[k].ref_id] for k in have])
    return {"sequence": name, "seed": seed, "frames": out["frames"], "loops": out["loops"],
            "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
            "lost": out["lost"], "ate_odom": out["ate_odom"],
            "ate_slam": metrics.ate_rmse(est, spec["poses"][have]),
            "ate_slam_frames": len(have),
            "optimized_poses": len(opt),
            "nodes": len(out["slam"].memory.signatures),
            "n_words": out["slam"].memory.vocab.n_words,
            "seconds": round(time.time() - t0, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", nargs="+", default=["parity", "full"])
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC keys")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.seed:
        _seed_engines(args.seed)
    for name in args.sequence:
        print(json.dumps(run(name, args.seed)), flush=True)


if __name__ == "__main__":
    main()

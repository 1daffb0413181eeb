"""Reference run of the JAX package for the port's F2F and mono checks.

Renders the runs of ``rtabmap_tpu_torch/tools/odometries.py`` (``f2f``:
the first lap of rgbd_laps' ``full`` sequence at 640x480, RGB-D,
``Odom/Strategy`` 1; ``mono``: tests/test_odometry_mono.py's strafe at
640x480) with the JAX renderer and tracks them with the JAX package's
``FeatureExtractor`` and ``create_odometry`` on the CPU, the odometry's
key seeded with ``--seed``. Prints one JSON line a run with the keys of
the port tool's summary. ``chip_smoke.py`` takes its thresholds from
these numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_odometries.py [--run f2f mono] [--seed S]
        [--frames N] [--size W H]
"""
from __future__ import annotations

import argparse
import json
import time


def run(name: str, seed: int = 0, frames: int = 0, size=None) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.core.frame import FeatureExtractor
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.odometry import create_odometry
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools.odometries import run_spec, summarize

    spec = run_spec(name, frames, size)
    W, H = spec["size"]
    cam = C.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    rfn = jax.jit(lambda pose: render(pose, cam, world))
    p = Parameters()
    for k, v in spec["params"].items():
        p.set(k, v)
    fe = FeatureExtractor(cam, p, max_kp=spec["max_kp"])
    odom = create_odometry(cam, p, strategy=None if name == "f2f" else "mono", seed=seed)
    times = {"extract_ms": [], "odom_ms": []}
    est = {}
    t0 = time.time()
    for i, pose in enumerate(spec["poses"]):
        gray, depth = rfn(jnp.asarray(pose))
        t = time.perf_counter()
        feat, _ = fe.extract(gray, depth if spec["depth"] else None)
        jax.block_until_ready(feat)
        times["extract_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        out, _, _ = odom.process(feat)
        if out is not None:
            est[i] = np.asarray(out)
        times["odom_ms"].append((time.perf_counter() - t) * 1e3)
    res = summarize(name, est, spec["poses"], times)
    return {**res, "seed": seed, "seconds": round(time.time() - t0, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", nargs="+", default=["f2f", "mono"])
    ap.add_argument("--seed", type=int, default=0, help="the odometry's key")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=None)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in args.run:
        print(json.dumps(run(name, args.seed, args.frames,
                             tuple(args.size) if args.size else None)), flush=True)


if __name__ == "__main__":
    main()

"""Reference runs of the JAX package for the port's stereo and
visual-inertial checks.

Writes the layouts of ``rtabmap_tpu_torch/tools/stereo_datasets.py``
(rendered by the port's renderer on the CPU, written by its PNG writer)
and runs the JAX package's dataset tools on them on the CPU, with the
RANSAC keys of the odometry and the engine shifted by ``--seed`` as the
port's ``run_dataset(seed=...)`` shifts its generators. Prints one JSON
line a run: loop closures, proximity links, lost frames, odometry and
SLAM ATE, the KITTI errors, seconds; for the ``kitti`` layout also the
share of the first frame's keypoints that keep a stereo 3D point (the
128 px disparity limit at KITTI 00's 386 / z px). ``chip_smoke.py`` takes
its thresholds from these numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_stereo_datasets.py --layouts DIR [--write]
        [--runs parity full kitti imu0 imu1] [--seed S]

``--write`` writes the layouts into DIR first (once; the seeds' runs can
then share DIR).
"""
from __future__ import annotations

import argparse
import functools
import json
import time


def _seed_engines(seed: int):
    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.odometry.f2m import OdometryF2M

    for cls, value in ((OdometryF2M, seed), (Rtabmap, 42 + seed)):
        cls.__init__ = functools.partialmethod(cls.__init__, seed=value)


def stereo_share(seq_dir: str) -> float:
    """Share of the first frame's keypoints with a stereo 3D point."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.datasets.readers import KittiDataset
    from rtabmap_tpu.ops import features as F, stereo as ST

    ds = KittiDataset(seq_dir)
    fr = next(iter(ds))
    gl, gr = jnp.asarray(fr.gray), jnp.asarray(fr.right)
    kps, _ = jax.jit(lambda g: F.detect_and_describe(g, 512))(gl)
    _, ok = ST.keypoints_3d_from_stereo(kps.uv, kps.valid, gl, gr, ds.stereo)
    return float(np.sum(np.asarray(ok)) / max(int(np.sum(np.asarray(kps.valid))), 1))


def run(tool_args, seed: int) -> dict:
    import numpy as np

    from rtabmap_tpu.tools import cli

    t0 = time.time()
    out = cli.TOOLS[tool_args[0]](tool_args[1:])
    hist = out["slam"].stats_history
    res = {"frames": out["frames"], "loops": out["loops"], "lost": out["lost"],
           "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
           "nodes": len(out["slam"].memory.signatures),
           "n_words": int(out["slam"].memory.vocab.n_words),
           "seconds": round(time.time() - t0, 1)}
    for k in ("ate_odom", "ate_slam", "kitti_t_err_pct", "kitti_r_err_deg_per_m"):
        if k in out:
            res[k] = float(np.asarray(out[k]))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layouts", required=True)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--runs", nargs="+", default=["parity", "full", "kitti", "imu0", "imu1"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rtabmap_tpu_torch.tools import stereo_datasets as SD

    tools = {name: (SD.write_layout(name, args.layouts, "cpu") if args.write
                    else SD.tool_args(name, args.layouts)) for name in args.runs}
    if args.write:
        print(json.dumps({"written": args.layouts, "runs": args.runs}), flush=True)
        return
    _seed_engines(args.seed)
    for name in args.runs:
        res = run(tools[name], args.seed)
        if name == "kitti":
            res["stereo_share_frame0"] = stereo_share(tools[name][-2])
        print(json.dumps({"run": name, "seed": args.seed, **res}), flush=True)


if __name__ == "__main__":
    main()

"""Reference run of the JAX package for the port's RGB-D SLAM checks.

Renders the sequences of ``rtabmap_tpu_torch/tools/rgbd_laps.py``
(``parity``: the sequence of ``tests/test_slam_e2e.py`` at 320x240;
``full``: two 60-frame laps at 640x480; ``full-revisit``: the same with
an exact second lap) with the JAX renderer and runs them through the JAX
package's ``run_dataset`` (``FeatureExtractor`` -> ``OdometryF2M`` ->
``Rtabmap.process``, default parameters) on the CPU. ``--learned`` sets
``Kp/DetectorStrategy`` 11 and ``Vis/CorNNType`` 6 (``rgbd_laps.LEARNED``);
``--strategy N`` sets ``Kp/DetectorStrategy`` N (a classical front end)
and ``--cor-nn-type N`` ``Vis/CorNNType`` N (7: GMS);
``--gt-odometry`` feeds each frame's features and ground-truth pose
straight into ``Rtabmap.process`` (the loop of
``tests/test_learned_stack.py``) and prints each frame's highest
hypothesis id and value. Prints, per sequence, one JSON line: loop
closures, proximity links, lost frames, odometry and SLAM ATE, the
closure links' errors. ``chip_smoke.py`` takes its thresholds from these
numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_rgbd_laps.py [--sequence parity full full-revisit]
        [--seed S] [--learned | --strategy N] [--cor-nn-type N] [--gt-odometry]
        [--frames N]
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


def run_gt_odometry(frames, cam, p, max_kp: int, node_capacity: int, seed: int) -> dict:
    """Features and ground-truth poses straight into the JAX engine."""
    from rtabmap_tpu.core.frame import FeatureExtractor
    from rtabmap_tpu.engine.rtabmap import Rtabmap

    import numpy as np

    fe = FeatureExtractor(cam, p, max_kp=max_kp)
    slam = Rtabmap(cam, p, node_capacity=node_capacity, words_per_frame=max_kp,
                   seed=42 + seed)
    hyp_ids, hyp_values, loops, n = [], [], 0, 0
    for i, fr in enumerate(frames):
        feat, descf = fe.extract(fr.gray, fr.depth)
        st = slam.process(feat, fr.gt_pose, np.eye(6) * 1e-4, stamp=float(i),
                          gt_pose=fr.gt_pose, descf=descf)
        loops += int(st.loop_closure_id > 0)
        hyp_ids.append(int(st.get("Loop/Highest hypothesis id/", 0)))
        hyp_values.append(float(st.get("Loop/Highest hypothesis value/", 0.0)))
        n += 1
    return {"frames": n, "loops": loops, "lost": 0, "ate_odom": 0.0, "slam": slam,
            "hyp_ids": hyp_ids, "hyp_values": hyp_values}


def run(name: str, seed: int = 0, learned: bool = False, gt_odometry: bool = False,
        strategy=None, cor_nn_type=None, frames: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.datasets.readers import Frame
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.tools.dataset_runner import run_dataset
    from rtabmap_tpu.utils import metrics
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools.rgbd_laps import LEARNED, closure_errors, sequence_spec

    spec = sequence_spec(name)
    if frames:
        spec["poses"] = spec["poses"][:frames]
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
    p = Parameters()
    if learned:
        for k, v in LEARNED.items():
            p.set(k, v)
    if strategy is not None:
        p.set("Kp/DetectorStrategy", strategy)
    if cor_nn_type is not None:
        p.set("Vis/CorNNType", cor_nn_type)
    if gt_odometry:
        out = run_gt_odometry(frames(), cam, p, spec["max_kp"], spec["node_capacity"], seed)
    else:
        out = run_dataset(frames(), cam, p, max_kp=spec["max_kp"],
                          node_capacity=spec["node_capacity"], verbose=False)
    slam = out["slam"]
    cerr = closure_errors(slam)
    hist = slam.stats_history
    opt = slam.get_optimized_poses()
    # each frame's node; a node the graph dropped (e.g. an earlier session
    # after a lost frame) leaves its frames out of the SLAM ATE
    have = [k for k, s in enumerate(hist) if s.ref_id in opt]
    est = np.stack([opt[hist[k].ref_id] for k in have])
    extra = {k: out[k] for k in ("hyp_ids", "hyp_values") if k in out}
    return {"sequence": name, "seed": seed, "learned": learned, "gt_odometry": gt_odometry,
            "strategy": int(p["Kp/DetectorStrategy"]),
            "frames": out["frames"], "loops": out["loops"],
            "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
            "lost": out["lost"], "ate_odom": out["ate_odom"],
            "ate_slam": metrics.ate_rmse(est, spec["poses"][have]),
            "ate_slam_frames": len(have),
            "optimized_poses": len(opt),
            "nodes": len(out["slam"].memory.signatures),
            "n_words": out["slam"].memory.vocab.n_words,
            "closure_links": int(cerr.size),
            "closure_err_median_m": float(np.median(cerr)) if cerr.size else 0.0,
            "closure_err_max_m": float(cerr.max()) if cerr.size else 0.0,
            "cor_nn_type": slam.memory.cor_nn_type,
            "valid_keypoints_median": float(np.median(
                [int(np.sum(s.desc.any(axis=1))) for s in slam.memory.signatures.values()
                 if s.desc is not None])),
            "seconds": round(time.time() - t0, 1), **extra}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", nargs="+", default=["parity", "full"])
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC keys")
    ap.add_argument("--learned", action="store_true",
                    help="Kp/DetectorStrategy 11 and Vis/CorNNType 6")
    ap.add_argument("--strategy", type=int, default=None,
                    help="Kp/DetectorStrategy N (a classical front end)")
    ap.add_argument("--cor-nn-type", type=int, default=None, help="Vis/CorNNType N")
    ap.add_argument("--frames", type=int, default=0, help="cut each sequence (0 = whole)")
    ap.add_argument("--gt-odometry", action="store_true",
                    help="ground-truth poses into Rtabmap.process, no odometry")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.seed and not args.gt_odometry:
        _seed_engines(args.seed)
    for name in args.sequence:
        print(json.dumps(run(name, args.seed, args.learned, args.gt_odometry,
                             args.strategy, args.cor_nn_type, args.frames)), flush=True)


if __name__ == "__main__":
    main()

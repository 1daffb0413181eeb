"""The spread of the F2M odometry over RANSAC seeds, in both packages.

Renders one session of ``rtabmap_tpu_torch/tools/rgbd_sessions.py`` (the
localization's 20 frames by default) with the JAX renderer, extracts the
features once with the JAX package, and runs, for each seed, the odometry
of each mode on those features:

- ``jax``: the JAX package's ``OdometryF2M(seed=S)`` (its key, split a tick);
- ``port``: the port's ``OdometryF2M(seed=S)`` (its CPU torch generator);
- ``port_jax_draws``: the port's ``odom_step`` given the JAX twin's samples
  for seed S (``indices=``), as ``scripts/f2m_injected_draws.py`` does.

Prints one JSON line a run (the ATE against the ground truth, the median
and largest frame-to-frame translation error) and one a mode: the ATE's
mean, median and 90th percentile over the seeds, and how many seeds have a
frame-to-frame error past 35 mm and past 60 mm (the tail that moves the
localization counts of ``chip_smoke.py``'s ``rgbd_sessions`` phase).

Usage (from the repository root; CPU, a few seconds a run):
    PYTHONPATH=. python scripts/f2m_seed_spread.py [--session localization]
        [--seeds 0:80] [--modes jax port port_jax_draws]
"""
from __future__ import annotations

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--session", default="localization")
    ap.add_argument("--seeds", default="0:80", help="first:last (exclusive)")
    ap.add_argument("--modes", nargs="*", default=["jax", "port", "port_jax_draws"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    from rtabmap_tpu.core.frame import FrameFeatures as JFrame
    from rtabmap_tpu.core.frame import extract_features
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.geometry import camera as JC
    from rtabmap_tpu.odometry import f2m as JF
    from rtabmap_tpu.ops import ransac as JR
    from rtabmap_tpu.utils.params import Parameters as JParams
    from rtabmap_tpu_torch.core.frame import FrameFeatures
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.odometry import f2m as F
    from rtabmap_tpu_torch.ops import matching as M
    from rtabmap_tpu_torch.tools import rgbd_sessions as S
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
    from rtabmap_tpu_torch.utils import metrics
    from rtabmap_tpu_torch.utils.params import Parameters

    torch.set_num_threads(4)
    spec = sequence_spec("full")
    poses = S.session_poses(args.session)
    jcam, cam = JC.CameraModel.make(*S.camera()), C.CameraModel.make(*S.camera())
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    extract = jax.jit(lambda pose: extract_features(*render(pose, jcam, world), jcam,
                                                    spec["max_kp"]))
    feats = [tuple(np.array(x) for x in extract(jnp.asarray(p))) for p in poses]
    iters = 192                              # odom_step's ransac_iters in both

    def run_jax(seed):
        jo = JF.OdometryF2M(jcam, JParams(), seed=seed)
        out = []
        for f in feats:
            jo.process(JFrame(*(jnp.asarray(x) for x in f)))
            out.append(np.asarray(jo.state.pose))
        return out

    def run_port(seed):
        po = F.OdometryF2M(cam, Parameters(), seed=seed, device="cpu")
        out = []
        for f in feats:
            po.process(FrameFeatures(*(torch.from_numpy(x) for x in f)))
            out.append(po.state.pose.numpy().copy())
        return out

    def run_port_jax_draws(seed):
        po = F.OdometryF2M(cam, Parameters(), device="cpu")
        key, out = jax.random.PRNGKey(seed), []
        for f in feats:
            key, sub = jax.random.split(key)  # as the JAX OdometryF2M.process
            pf = FrameFeatures(*(torch.from_numpy(x) for x in f))
            idx = None
            if po.state.initialized:
                m = M.match_nndr(pf.desc, pf.valid, po.state.map_desc, po.state.map_valid,
                                 nndr=po.nndr)
                v = jnp.asarray(m.valid.numpy())
                idx = tuple(torch.from_numpy(np.array(JR._sample_indices(k, v, n, s)))
                            for k, n, s in ((sub, iters // 2, 6),
                                            (jax.random.fold_in(sub, 1), iters - iters // 2, 3)))
            po.state, res = F.odom_step(po.state, pf, cam, reproj_px=po.reproj_px,
                                        min_inliers=po.min_inliers,
                                        keyframe_thr=po.keyframe_thr, nndr=po.nndr,
                                        indices=idx)
            if res.success and po.ba_enabled and res.keyframe_added:
                po.state = F.local_ba_step(po.state, cam)
            out.append(po.state.pose.numpy().copy())
        return out

    def step_errors(est):
        h = lambda p: np.vstack([p, [0.0, 0.0, 0.0, 1.0]])  # noqa: E731
        return np.array([np.linalg.norm((np.linalg.inv(h(est[i - 1])) @ h(est[i]))[:3, 3]
                                        - (np.linalg.inv(h(poses[i - 1])) @ h(poses[i]))[:3, 3])
                         for i in range(1, len(poses))])

    runners = {"jax": run_jax, "port": run_port, "port_jax_draws": run_port_jax_draws}
    lo, hi = (int(x) for x in args.seeds.split(":"))
    for mode in args.modes:
        ates, worst = [], []
        for seed in range(lo, hi):
            est = np.stack(runners[mode](seed))
            err = step_errors(est)
            ates.append(metrics.ate_rmse(est, poses))
            worst.append(float(err.max()))
            print(json.dumps({"mode": mode, "seed": seed, "ate_m": ates[-1],
                              "step_err_median_mm": float(np.median(err) * 1e3),
                              "step_err_max_mm": worst[-1] * 1e3}), flush=True)
        worst = np.asarray(worst)
        print(json.dumps({"mode": mode, "session": args.session, "seeds": [lo, hi],
                          "ate_mean_m": float(np.mean(ates)),
                          "ate_median_m": float(np.median(ates)),
                          "ate_p90_m": float(np.percentile(ates, 90)),
                          "seeds_step_err_past_35mm": int((worst > 0.035).sum()),
                          "seeds_step_err_past_60mm": int((worst > 0.060).sum())}), flush=True)


if __name__ == "__main__":
    main()

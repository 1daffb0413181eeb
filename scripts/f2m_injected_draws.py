"""The port's F2M odometry against the JAX package's over a whole sequence,
with the JAX package's RANSAC draws given to the port.

Both run ``rgbd_laps``' ``full`` sequence (two 60-frame laps at 640x480)
on the same features, extracted once by the JAX package, with their
wrappers' parameters; each frame the JAX twin draws its samples with its
key and the port gets the same samples (``indices=``). Prints, every ten
frames and wherever the poses part by more than 1 mm, both sides' inlier
counts and keyframe decisions and their pose difference, then the frames
whose counts or decisions differ and both trajectories' ATE against the
ground truth. Equal counts and decisions
with sub-millimetre to millimetre pose differences mean the two
odometries differ only by their draws.

Usage (from the repository root; CPU, about 5 minutes):
    PYTHONPATH=. python scripts/f2m_injected_draws.py
"""
from __future__ import annotations

import json


def main():
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
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
    from rtabmap_tpu_torch.utils import metrics
    from rtabmap_tpu_torch.utils.params import Parameters

    torch.set_num_threads(4)
    spec = sequence_spec("full")
    W, H = spec["size"]
    cam_args = (spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    jcam, cam = JC.CameraModel.make(*cam_args), C.CameraModel.make(*cam_args)
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    extract = jax.jit(lambda pose: extract_features(*render(pose, jcam, world), jcam,
                                                    spec["max_kp"]))
    jo = JF.OdometryF2M(jcam, JParams())
    po = F.OdometryF2M(cam, Parameters(), device="cpu")
    iters = 192                              # odom_step's ransac_iters in both
    jest, pest, mismatched = [], [], 0
    for i, pose in enumerate(spec["poses"]):
        f = tuple(np.array(x) for x in extract(jnp.asarray(pose)))
        jo._key, key = jax.random.split(jo._key)
        jo.state, jr = jo._step(jo.state, JFrame(*(jnp.asarray(x) for x in f)), key)
        if bool(jr.success) and jo.ba_enabled and bool(jr.keyframe_added):
            jo.state = jo._ba(jo.state)
        pf = FrameFeatures(*(torch.from_numpy(x) for x in f))
        idx = None
        if po.state.initialized:     # the JAX twin's samples for this key
            m = M.match_nndr(pf.desc, pf.valid, po.state.map_desc, po.state.map_valid,
                             nndr=po.nndr)
            v = jnp.asarray(m.valid.numpy())
            idx = tuple(torch.from_numpy(np.array(JR._sample_indices(k, v, n, s)))
                        for k, n, s in ((key, iters // 2, 6),
                                        (jax.random.fold_in(key, 1), iters - iters // 2, 3)))
        po.state, pr = F.odom_step(po.state, pf, cam, reproj_px=po.reproj_px,
                                   min_inliers=po.min_inliers, keyframe_thr=po.keyframe_thr,
                                   nndr=po.nndr, indices=idx)
        if pr.success and po.ba_enabled and pr.keyframe_added:
            po.state = F.local_ba_step(po.state, cam)
        jest.append(np.asarray(jo.state.pose))
        pest.append(po.state.pose.numpy())
        diff = float(np.abs(jest[-1] - pest[-1]).max())
        mismatched += (int(jr.num_inliers), bool(jr.keyframe_added)) != (pr.num_inliers,
                                                                         pr.keyframe_added)
        if i % 10 == 0 or diff > 1e-3:
            print(json.dumps({"frame": i, "jax_inliers": int(jr.num_inliers),
                              "port_inliers": pr.num_inliers,
                              "jax_keyframe": bool(jr.keyframe_added),
                              "port_keyframe": pr.keyframe_added, "pose_diff": diff}),
                  flush=True)
    print(json.dumps({"frames": len(jest), "frames_with_other_inliers_or_keyframe": mismatched,
                      "ate_jax": metrics.ate_rmse(np.stack(jest), spec["poses"]),
                      "ate_port": metrics.ate_rmse(np.stack(pest), spec["poses"])}))


if __name__ == "__main__":
    main()

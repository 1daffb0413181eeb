"""Reference run of the JAX package for the port's two-lap BOWMapping check.

Renders the two-lap loop sequence that ``chip_smoke.py`` drives through the
port (``rtabmap_tpu_torch/tools/bow_laps.py``: 640x480, lap 1 =
``loop_trajectory(150)``, lap 2 = the same loop at radius 1.45 m and height
0.05 m), feeds it through the JAX package's
``FeatureExtractor.extract`` -> ``Rtabmap.process`` with RGBD/Enabled=false
on the CPU, and prints how many lap-2 frames close with a lap-1 node of the
same viewpoint (+-3 frames). ``chip_smoke.py`` takes its threshold from
this count. The sizes are the port's: 400 keypoints, the default
262144-word vocabulary, 1024 node slots.

Usage (from the repository root): PYTHONPATH=. python scripts/jax_bow_laps.py [--frames-per-lap 150]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames-per-lap", type=int, default=150)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from rtabmap_tpu.core.frame import FeatureExtractor
    from rtabmap_tpu.datasets.synthetic import loop_trajectory, render
    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools.bow_laps import same_view_closures

    n = args.frames_per_lap
    W, H = 640, 480
    cam = C.CameraModel.make(500.0, 500.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    p = Parameters({"RGBD/Enabled": False})
    slam = Rtabmap(cam, p, node_capacity=1024, words_per_frame=400)
    fe = FeatureExtractor(cam, p, max_kp=400)
    rfn = jax.jit(lambda pose: render(pose, cam))
    poses = np.concatenate([np.asarray(loop_trajectory(n)),
                            np.asarray(loop_trajectory(n, radius=1.45, height=0.05))])
    closures, node_frames = [], {}
    t0 = time.time()
    for i, pose in enumerate(poses):
        gray, _ = rfn(pose)
        fr, _ = fe.extract(gray, None)
        st = slam.process(fr, pose, stamp=float(i))
        node_frames.setdefault(st.ref_id, []).append(i)
        if st.loop_closure_id:
            closures.append((i, int(st.loop_closure_id)))
    lap2_closures = [(i, lc) for i, lc in closures if i >= n]
    print(json.dumps({
        "frames": 2 * n, "closures": len(closures),
        "lap2_closures": len(lap2_closures),
        "lap2_same_view": same_view_closures(lap2_closures, node_frames, n),
        "n_words": slam.memory.vocab.n_words, "nodes": len(slam.memory.signatures),
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()

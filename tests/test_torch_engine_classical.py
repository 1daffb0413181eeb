"""A classical front end through both engines at engine scale (slow).

``Kp/DetectorStrategy`` 2 (ORB: FAST + rotated BRIEF) on the RGB-D
parity sequence (tests/test_slam_e2e.py's 58 frames at 320x240, 384
keypoints) through each package's ``run_dataset`` on the CPU: feature
extraction, F2M odometry, quantization, closures and graph optimization.
On this sequence FAST keeps about 30 keypoints a frame (the smooth
value-noise walls rarely pass its 0.04 contrast margin) and the F2M
odometry of both packages loses track after the first frame and never
recovers (ROADMAP.md section 3): a run that depends on no RANSAC draw. So
the runs are held to each other exactly: lost frames, loops, proximity
links and vocabulary words equal, both ATEs within 1e-3 m (float32 sums
in another order)."""
import pytest

from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.slow
def test_orb_parity_through_both_engines():
    import os
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import jax_rgbd_laps
    from rtabmap_tpu_torch.tools.rgbd_laps import front_end_params, run_sequence

    port = run_sequence("parity", device="cpu", params=front_end_params(strategy=2))
    ref = jax_rgbd_laps.run("parity", strategy=2)
    assert port["run"]["slam"].params["Kp/DetectorStrategy"] == 2 and ref["strategy"] == 2
    for key in ("frames", "lost", "loops", "proximity", "n_words", "ate_slam_frames"):
        assert port[key] == ref[key], key
    assert port["lost"] == 57
    for key in ("ate_odom", "ate_slam"):
        assert abs(port[key] - ref[key]) <= 1e-3, key

"""The LiDAR mapping slice end to end (odometry, proximity closures, dense
pose graph, voxel map) and its simulator: the port (device="cpu") against
the JAX package.

The quick case feeds both sides the same numpy scans, 36 frames of 72 x 16
(16 rings: every map normal well defined, see tests/test_torch_cloud.py).
Tolerances and why: the closure list and lost count exactly; optimized and
odometry poses within 1e-3 and both ATEs within 1e-3 (36 frames of ICP on
float32 sums taken in another order; measured 1.4e-4 and 2e-6); occupied
voxels within 0.5% (a voxel whose endpoint moved by 1e-4 can change).

``run_synthetic`` generates its scans on each side: the port's simulator
agrees with the JAX one within 5e-5 m (tests/test_torch_cloud.py), but a
voxel filter is discontinuous, so a point on a cell border can survive on one side only;
the slow case therefore holds closures, lost frames, ATEs and occupancy,
not single poses (measured: 7.5e-3 m apart at 40 frames of 90 x 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.tools import lidar_mapping as JLM
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from rtabmap_tpu_torch.tools import lidar_mapping as LM
from torch_port_threads import one_torch_thread  # noqa: F401


def _poses(out, key):
    return np.stack([out[key][i] for i in sorted(out[key])])


def test_run_lidar_mapping_matches_jax():
    gt = np.asarray(JS.lidar_trajectory(36, radius=2.0))
    scans = [tuple(np.array(a) for a in JS.lidar_scan(jnp.asarray(p), n_azimuth=72, n_rings=16))
             for p in gt]
    oj = JLM.run_lidar_mapping(iter(scans), gt_poses=gt)
    K2.nn3d.launches = 0
    ot = LM.run_lidar_mapping(iter(scans), gt_poses=gt, device="cpu")
    assert ot["closures"] == oj["closures"] and len(ot["closures"]) >= 1
    assert ot["lost"] == oj["lost"] == 0 and ot["nodes"] == oj["nodes"] == 36
    np.testing.assert_allclose(_poses(ot, "poses"), _poses(oj, "poses"), atol=1e-3)
    np.testing.assert_allclose(_poses(ot, "odom_poses"), _poses(oj, "odom_poses"), atol=1e-3)
    assert abs(ot["ate_slam"] - oj["ate_slam"]) <= 1e-3
    assert abs(ot["ate_odom"] - oj["ate_odom"]) <= 1e-3
    assert abs(ot["occupied_voxels"] - oj["occupied_voxels"]) <= 0.005 * oj["occupied_voxels"]
    # searches: 16 a tracked frame (+1 on a keyframe), 1 at the bootstrap,
    # 16 a registration; on CPU tensors none launches the kernel
    assert ot["nn3d_searches"] >= 16 * 35 + 1 and K2.nn3d.launches == 0
    assert len(ot["frame_ms"]) == 36 and ot["graph_ms"] > 0 and ot["map_ms"] > 0


@pytest.mark.slow
def test_run_synthetic_matches_jax():
    oj = JLM.run_synthetic(n_frames=40, n_azimuth=90, n_rings=16)
    ot = LM.run_synthetic(n_frames=40, n_azimuth=90, n_rings=16, device="cpu")
    assert ot["closures"] == oj["closures"] and ot["lost"] == oj["lost"]
    assert abs(ot["ate_slam"] - oj["ate_slam"]) <= 1e-3
    assert abs(ot["ate_odom"] - oj["ate_odom"]) <= 1e-3
    assert abs(ot["occupied_voxels"] - oj["occupied_voxels"]) <= 0.005 * oj["occupied_voxels"]

"""Block-sparse voxel occupancy map and trajectory metrics: the port
(device="cpu") against the JAX package.

Tolerances and why: the voxel map's brick table and log-odds bricks
exactly (each voxel gets one +0.85 or -0.7 per scan after the host
collapse, so no sum depends on an order; the ray samples are the same
float32 products of the same inputs); queries and occupied voxels exactly.
Metrics: ATE exactly in float64 on the same inputs, RPE within 1e-6 (its
relative poses are float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import torch

from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.maps.voxel import VoxelOccupancyMap as JaxVoxelMap
from rtabmap_tpu.utils import metrics as JM
from rtabmap_tpu_torch.maps.voxel import VoxelOccupancyMap
from rtabmap_tpu_torch.utils import metrics as M
from torch_port_threads import one_torch_thread  # noqa: F401


def test_voxel_map_matches_jax():
    poses = np.asarray(JS.lidar_trajectory(25, radius=2.0))
    jm, tm = JaxVoxelMap(voxel=0.1), VoxelOccupancyMap(voxel=0.1, device="cpu")
    for i in (0, 4, 9):
        pts, valid = [np.array(a) for a in JS.lidar_scan(jnp.asarray(poses[i]),
                                                         n_azimuth=180, n_rings=6)]
        valid[::11] = False
        jm.update(i, poses[i], jnp.asarray(pts), jnp.asarray(valid))
        tm.update(i, poses[i], torch.from_numpy(pts), torch.from_numpy(valid))
    assert tm.table == jm.table and len(tm.table) > 10
    np.testing.assert_array_equal(tm.bricks.numpy(), np.asarray(jm.bricks))
    cj, pj, _ = jm.occupied_voxels()
    ct, pt, _ = tm.occupied_voxels()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(pt, pj)
    probe = np.random.default_rng(0).uniform(-4, 4, (500, 3))
    np.testing.assert_array_equal(tm.query(probe), jm.query(probe))
    # re-updating a node re-assembles the map at its new pose
    moved = poses[4].copy()
    moved[0, 3] += 0.2
    pts, valid = tm.cache[4][:2]
    jm.update(4, moved, jnp.asarray(pts), jnp.asarray(valid))
    tm.update(4, moved, torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(tm.bricks.numpy(), np.asarray(jm.bricks))


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    gt = np.asarray(JS.lidar_trajectory(30, radius=2.0)).astype(np.float64)
    est = gt.copy()
    est[:, :, 3] += rng.normal(0, 0.05, (30, 3))
    est = est.astype(np.float32)
    for scale in (False, True):
        assert M.ate_rmse(est, gt, with_scale=scale) == JM.ate_rmse(est, gt, with_scale=scale)
    s, R, t = M.align_umeyama(est[:, :, 3], gt[:, :, 3])
    sj, Rj, tj = JM.align_umeyama(est[:, :, 3], gt[:, :, 3])
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_allclose(M.rpe(est, gt, delta=2), JM.rpe(est, gt, delta=2), atol=1e-6)
    st, sj = M.summarize(est, gt), JM.summarize(est, gt)
    assert st.keys() == sj.keys()
    for k in st:
        np.testing.assert_allclose(st[k], sj[k], atol=1e-6)

"""Scan-to-map ICP odometry and the odometry factory: the port (device="cpu")
against the JAX package on the same scans.

The sequence is the first 12 frames of ``tests/test_scan_odometry.py``
(``lidar_trajectory(25)``, 0.5 m a frame, scan voxel 0.08 m, a 2048-point
map), with 90 x 16 scans instead of 180 x 6: on 6-ring scans 1.7% of the
map normals are ill-defined (tests/test_torch_cloud.py) and the two sides
pick different ones, which moves ICP by up to 1e-3 and then the keyframe
merges apart. Both sides get the same numpy scans (a voxel filter is
discontinuous, so independently generated scans could keep other points).

Tolerances and why: poses within 1e-4 (ICP on float32 sums in another
order, the JAX CPU search in the expanded form; measured 1.3e-5); keyframe
flags and map point counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.odometry.scan_f2m import OdometryScanF2M as JaxOdometry
from rtabmap_tpu.utils.params import Parameters as JaxParameters
from rtabmap_tpu_torch.odometry import create_odometry
from rtabmap_tpu_torch.odometry.scan_f2m import OdometryScanF2M, state_from_numpy
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

ICP = {"Icp/MaxCorrespondenceDistance": 0.5, "Icp/Iterations": 15,
       "Icp/CorrespondenceRatio": 0.2}
N_FRAMES, HANDOVER = 12, 6


@pytest.fixture(scope="module")
def jax_run():
    poses = np.asarray(JS.lidar_trajectory(25, radius=2.0))[:N_FRAMES]
    scans = [tuple(np.array(a) for a in JS.lidar_scan(jnp.asarray(p), n_azimuth=90, n_rings=16))
             for p in poses]
    odom = JaxOdometry(params=JaxParameters(ICP), map_capacity=2048, scan_voxel=0.08)
    out, handover = [], None
    for i, (pts, valid) in enumerate(scans):
        if i == HANDOVER:
            handover = {k: np.array(v) for k, v in odom.state._asdict().items()}
        pose, _, info = odom.process(jnp.asarray(pts), jnp.asarray(valid))
        out.append((np.asarray(pose), info))
    return scans, out, handover


def _port_odometry():
    return OdometryScanF2M(params=Parameters(ICP), map_capacity=2048, scan_voxel=0.08,
                           device="cpu")


def _check(port_steps, jax_steps):
    for i, ((pose_t, info_t), (pose_j, info_j)) in enumerate(zip(port_steps, jax_steps)):
        np.testing.assert_allclose(pose_t.numpy(), pose_j, atol=1e-4, err_msg=f"frame {i}")
        assert info_t["keyframe"] == info_j["keyframe"], i
        assert info_t["map_points"] == info_j["map_points"], i
        assert abs(info_t["corr_ratio"] - info_j["corr_ratio"]) <= 1e-4, i


def test_scan_odometry_matches_jax(jax_run):
    scans, jax_steps, _ = jax_run
    odom = _port_odometry()
    steps = []
    for pts, valid in scans:
        pose, cov, info = odom.process(pts, valid)
        assert pose is not None
        steps.append((pose, info))
    _check(steps, jax_steps)
    assert sum(info["keyframe"] for _, info in steps) >= 2
    # K2 searches: 1 at the bootstrap merge; Icp/Iterations + 1 a frame,
    # one more on a keyframe
    assert steps[0][1]["nn_searches"] == 1
    assert all(info["nn_searches"] == 16 + info["keyframe"] for _, info in steps[1:])
    assert all(info["nn_plans"] == 1 + info["keyframe"] for _, info in steps[1:])


def test_state_from_numpy_continues_a_jax_sequence(jax_run):
    scans, jax_steps, handover = jax_run
    odom = _port_odometry()
    odom.state = state_from_numpy(handover, device="cpu")
    assert odom.state.map_valid.dtype == torch.bool and bool(odom.state.initialized)
    steps = []
    for pts, valid in scans[HANDOVER:]:
        pose, _, info = odom.process(pts, valid)
        steps.append((pose, info))
    _check(steps, jax_steps[HANDOVER:])


def test_lost_on_garbage_and_factory():
    odom = _port_odometry()
    pts, valid = JS.lidar_scan(JS.lidar_trajectory(10)[0], n_azimuth=120, n_rings=4)
    odom.process(np.array(pts), np.array(valid))
    junk = 100.0 + np.random.RandomState(0).rand(480, 3).astype(np.float32)
    pose, cov, info = odom.process(junk, np.ones(480, bool))
    assert pose is None and float(cov[0, 0]) >= 9999.0 and odom.lost

    p = Parameters(ICP).set("Reg/Strategy", 1)
    assert isinstance(create_odometry(None, p, device="cpu"), OdometryScanF2M)
    # F2F and mono are ported (tests/test_torch_odometry_f2f.py,
    # tests/test_torch_odometry_mono.py)
    from rtabmap_tpu_torch.odometry.f2f import OdometryF2F
    from rtabmap_tpu_torch.odometry.mono import OdometryMono

    for strategy, cls in (("f2f", OdometryF2F), ("mono", OdometryMono)):
        assert isinstance(create_odometry(None, None, strategy=strategy, device="cpu"), cls)
    # Odom/Strategy 0, Reg/Strategy 0: the visual F2M odometry
    from rtabmap_tpu_torch.geometry.camera import CameraModel
    from rtabmap_tpu_torch.odometry.f2m import OdometryF2M

    cam = CameraModel.make(100.0, 100.0, 80.0, 60.0, 160, 120)
    assert isinstance(create_odometry(cam, Parameters(), device="cpu"), OdometryF2M)
    assert isinstance(create_odometry(cam, None, strategy="f2m", device="cpu"), OdometryF2M)
    with pytest.raises(RuntimeError):
        create_odometry(None, None, strategy="loam")

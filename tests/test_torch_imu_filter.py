"""The IMU filters (Madgwick and complementary) and the gravity alignment
of a pose: the port against the JAX twin on seeded IMU batches, with the
tolerances of tests/test_torch_flow_imu.py (REL, 1e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.memory import memory as JMEM
from rtabmap_tpu.odometry import imu_filter as JIMU
from rtabmap_tpu.ops import flow as JFL
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.core.frame import extract_features
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory import memory as MEM
from rtabmap_tpu_torch.odometry import imu_filter as IMU
from rtabmap_tpu_torch.ops import flow as FL
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_flow_imu import _imu_batch  # noqa: F401


@pytest.mark.parametrize("method", ["madgwick", "complementary"])
def test_imu_filters_match_the_twin(method):
    gyro, accel, dt, q0 = _imu_batch()
    qs = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    upd_p = IMU.madgwick_update if method == "madgwick" else IMU.complementary_update
    upd_j = JIMU.madgwick_update if method == "madgwick" else JIMU.complementary_update
    got = upd_p(*(torch.from_numpy(x) for x in (qs, gyro, accel)), torch.from_numpy(dt)[:, None])
    ref = upd_j(*(jnp.asarray(x) for x in (qs, gyro, accel)), jnp.asarray(dt)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    got = IMU.integrate_imu(*(torch.from_numpy(x) for x in (gyro, accel, dt, q0)),
                            method=method)
    ref = JIMU.integrate_imu(*(jnp.asarray(x) for x in (gyro, accel, dt, q0)), method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    # the dt = 0 padding leaves the last real sample's orientation (Madgwick)
    if method == "madgwick":
        np.testing.assert_allclose(got[-1].numpy(), got[-9].numpy(), atol=1e-7)
    default = IMU.integrate_imu(*(torch.from_numpy(x[:4]) for x in (gyro, accel, dt)),
                                method=method)
    ref = JIMU.integrate_imu(*(jnp.asarray(x[:4]) for x in (gyro, accel, dt)), method=method)
    np.testing.assert_allclose(default.numpy(), np.asarray(ref), atol=2e-6)


def test_gravity_alignment_matches_the_twin():
    rng = np.random.default_rng(2)
    xyzrpy = rng.uniform(-1.2, 1.2, (32, 6)).astype(np.float32)
    poses = T.from_xyzrpy(torch.from_numpy(xyzrpy))
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    got = IMU.apply_gravity_alignment(poses, torch.from_numpy(q)).numpy()
    ref = np.asarray(JIMU.apply_gravity_alignment(jnp.asarray(poses.numpy()), jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    rpy, rpy_q = T.to_xyzrpy(torch.from_numpy(got)), T.to_xyzrpy(T.from_quaternion(
        torch.from_numpy(q)))
    np.testing.assert_allclose(rpy[:, 3:5].numpy(), rpy_q[:, 3:5].numpy(), atol=1e-4)
    np.testing.assert_allclose(rpy[:, [0, 1, 2, 5]].numpy(), xyzrpy[:, [0, 1, 2, 5]], atol=1e-4)
    for k in range(4):
        np.testing.assert_allclose(IMU.gravity_aligned_correction(torch.from_numpy(q[k])).numpy(),
                                   np.asarray(JIMU.gravity_aligned_correction(jnp.asarray(q[k]))),
                                   atol=1e-5)

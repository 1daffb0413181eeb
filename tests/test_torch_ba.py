"""Bundle adjustment: the port's bundle_adjust, bundle_adjust_large and
outlier_mask against the JAX twins on the problems of tests/test_ba.py.

Tolerances: refined poses and points to 1e-4, the final cost to 1e-3
relative (float32 LM: the point blocks are summed by index_add_, the
reduced camera system is solved by another LU, and each step's accept
test compares two costs); the outlier mask exactly. The implicit-Schur
``bundle_adjust_large`` is held to its twin the same way (its fixed-length
CG sums the same products in another order) and, like the twin's test, to
the dense solve's converged cost."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.optim import ba as JBA
from rtabmap_tpu_torch.optim import ba as BA
from torch_port_threads import one_torch_thread  # noqa: F401


def _problem(key, nc=6, npts=120, noise_pose=0.05, noise_pt=0.05):
    """tests/test_ba.py's problem: cameras 0 and 1 fixed at the truth."""
    ks = jax.random.split(key, 6)
    pts_gt = jax.random.uniform(ks[0], (npts, 3), minval=-3, maxval=3) + jnp.array([0, 0, 8.0])
    poses_gt = jnp.stack([JT.from_xyzrpy(jnp.array([0.4 * i, 0.1 * (i % 2), 0.0, 0.0,
                                                    0.02 * i, 0.0])) for i in range(nc)])
    cam_idx = jnp.repeat(jnp.arange(nc, dtype=jnp.int32), npts)
    pt_idx = jnp.tile(jnp.arange(npts, dtype=jnp.int32), nc)
    pc = jax.vmap(lambda Tc: JT.apply(Tc[None], pts_gt[None])[0])(poses_gt)
    z = pc[..., 2]
    uv = (pc[..., :2] / z[..., None]).reshape(-1, 2)
    valid = z.reshape(-1) > 0.1
    poses0 = jax.vmap(JT.retract)(poses_gt, noise_pose * jax.random.normal(ks[2], (nc, 6)))
    poses0 = poses0.at[0].set(poses_gt[0]).at[1].set(poses_gt[1])
    pts0 = pts_gt + noise_pt * jax.random.normal(ks[3], (npts, 3))
    fixed = jnp.zeros((nc,), bool).at[0].set(True).at[1].set(True)
    return JBA.BAProblem(poses0, pts0, cam_idx, pt_idx, uv, valid, fixed)


def _port(prob):
    return BA.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


def _same(port_out, port_cost, ref_out, ref_cost):
    np.testing.assert_allclose(port_out.poses.numpy(), np.asarray(ref_out.poses), atol=1e-4)
    np.testing.assert_allclose(port_out.points.numpy(), np.asarray(ref_out.points), atol=1e-4)
    np.testing.assert_allclose(float(port_cost), float(ref_cost), rtol=1e-3, atol=1e-9)


def test_bundle_adjust_converges_like_the_twin():
    prob = _problem(jax.random.PRNGKey(0))
    ref, ref_cost = JBA.bundle_adjust(prob, iters=12, huber=1.0)
    out, cost = BA.bundle_adjust(_port(prob), iters=12, huber=1.0)
    _same(out, cost, ref, ref_cost)
    assert float(cost) < 1e-4


@pytest.mark.parametrize("iters", [1, 4])
def test_bundle_adjust_outlier_mask(iters):
    prob = _problem(jax.random.PRNGKey(1))
    prob = prob._replace(uv=prob.uv.at[:20].add(0.5))   # 20 corrupted observations
    ref, ref_cost = JBA.bundle_adjust(prob, iters=iters, huber=0.01)
    out, cost = BA.bundle_adjust(_port(prob), iters=iters, huber=0.01)
    _same(out, cost, ref, ref_cost)
    mask = BA.outlier_mask(out, 0.05).numpy()
    np.testing.assert_array_equal(mask, np.asarray(JBA.outlier_mask(ref, 0.05)))
    assert mask[:20].mean() > 0.8 and mask[20:].mean() < 0.05


def test_cam_reduce_and_residual_jacobian():
    rng = np.random.default_rng(2)
    ci = rng.integers(0, 5, 64).astype(np.int32)
    vals = rng.normal(size=(64, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(
        BA._cam_reduce(torch.from_numpy(ci).long(), torch.from_numpy(vals), 5).numpy(),
        np.asarray(JBA._cam_reduce(jnp.asarray(ci), jnp.asarray(vals), 5)), rtol=1e-5,
        atol=1e-5)
    Tcw = np.asarray(JT.from_xyzrpy(jnp.array([0.1, 0.2, -0.1, 0.05, -0.02, 0.1])))
    pts = (rng.normal(size=(64, 3)) + [0, 0, 5]).astype(np.float32)
    uv = rng.normal(scale=0.1, size=(64, 2)).astype(np.float32)
    ref = jax.vmap(lambda p, u: JBA._residual_jac(jnp.asarray(Tcw), p, u))(
        jnp.asarray(pts), jnp.asarray(uv))
    port = BA._residual_jac(torch.from_numpy(Tcw).expand(64, 3, 4), torch.from_numpy(pts),
                            torch.from_numpy(uv))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _large_problem(seed=0, Nc=6, Np=120, No=600):
    """tests/test_ba.py::test_large_ba_matches_dense's problem."""
    rng = np.random.RandomState(seed)
    pts = (rng.randn(Np, 3) * 0.8 + np.array([0, 0, 5])).astype(np.float32)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (Nc, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 0.5, Nc)
    ci = rng.randint(0, Nc, No).astype(np.int32)
    pi = rng.randint(0, Np, No).astype(np.int32)
    pc = pts[pi].copy()
    pc[:, 0] -= poses[ci][:, 0, 3]
    uv = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    noisy_pts = pts + 0.02 * rng.randn(Np, 3).astype(np.float32)
    noisy_poses = poses.copy()
    noisy_poses[1:, :3, 3] += 0.01 * rng.randn(Nc - 1, 3).astype(np.float32)
    fixed = np.zeros(Nc, bool)
    fixed[0] = True
    return JBA.BAProblem(*(jnp.asarray(x) for x in (
        noisy_poses, noisy_pts, ci, pi, uv, np.ones(No, bool), fixed)))


def test_bundle_adjust_large_matches_the_twin_and_the_dense_solve():
    prob = _large_problem()
    ref, ref_cost = JBA.bundle_adjust_large(prob, iters=8, cg_iters=40)
    out, cost = BA.bundle_adjust_large(_port(prob), iters=8, cg_iters=40)
    _same(out, cost, ref, ref_cost)
    dense, dense_cost = BA.bundle_adjust(_port(prob), iters=8)
    np.testing.assert_allclose(out.poses.numpy(), dense.poses.numpy(), atol=1e-4)
    assert float(cost) < 1e-4 and float(dense_cost) < 1e-4

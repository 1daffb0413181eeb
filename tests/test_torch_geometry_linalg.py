"""SE(3) geometry, small linear algebra and the weighted rigid fit: the port
against the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances and why: float32 throughout; the two frameworks sum in other
orders (XLA on the CPU may fuse multiply-adds), so values agree to a few
ulps of their magnitude: 1e-6 absolute for rotations, poses and unit
vectors, 1e-5 for tangents, eigenvalues and solves. Branches are held
exactly: the small-angle and near-pi cases of ``so3_log``, the diagonal
(p1 < 1e-20) and isotropic (+z) fallbacks of the eigen solver, the rank-2
completion of the rigid fit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.ops import linalg as JL
from rtabmap_tpu.ops.ransac import rigid_from_correspondences as j_rigid
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import linalg as L
from rtabmap_tpu_torch.ops.ransac import rigid_from_correspondences
from torch_port_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _xi(n=64, seed=0, scale=0.8):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, scale, (n, 6)).astype(np.float32)
    xi[0] = 0.0                                   # identity
    xi[1, 3:] = [1e-8, 0.0, 0.0]                  # tiny angle
    xi[2, 3:] = [0.0, np.pi - 1e-6, 0.0]          # near pi
    xi[3, 3:] = np.array([1.0, -2.0, 0.5]) / np.linalg.norm([1.0, -2.0, 0.5]) * (np.pi - 1e-4)
    return xi


def test_se3_exp_log_and_jacobians():
    xi = _xi()
    P = T.se3_exp(_t(xi))
    _close(P, JT.se3_exp(jnp.asarray(xi)), 1e-6)
    Pj = np.asarray(JT.se3_exp(jnp.asarray(xi)))
    _close(T.se3_log(_t(Pj)), JT.se3_log(jnp.asarray(Pj)), 1e-5)
    phi = xi[:, 3:]
    _close(T.so3_exp(_t(phi)), JT.so3_exp(jnp.asarray(phi)), 1e-6)
    R = Pj[:, :, :3]
    _close(T.so3_log(_t(R)), JT.so3_log(jnp.asarray(R)), 1e-5)
    _close(T.so3_hat(_t(phi)), JT.so3_hat(jnp.asarray(phi)), 0)
    _close(T._so3_left_jacobian(_t(phi)), JT._so3_left_jacobian(jnp.asarray(phi)), 1e-6)
    _close(T._so3_left_jacobian_inv(_t(phi)), JT._so3_left_jacobian_inv(jnp.asarray(phi)), 1e-5)
    _close(T.rotation_angle(_t(Pj)), JT.rotation_angle(jnp.asarray(Pj)), 1e-6)


def test_pose_algebra():
    A = np.asarray(JT.se3_exp(jnp.asarray(_xi(32, 1))))
    B = np.asarray(JT.se3_exp(jnp.asarray(_xi(32, 2))))
    pts = np.random.default_rng(3).normal(size=(32, 50, 3)).astype(np.float32)
    ja, jb, tp = jnp.asarray(A), jnp.asarray(B), jnp.asarray(pts)
    _close(T.compose(_t(A), _t(B)), JT.compose(ja, jb), 1e-6)
    _close(T.inverse(_t(A)), JT.inverse(ja), 1e-6)
    _close(T.relative(_t(A), _t(B)), JT.relative(ja, jb), 1e-5)
    _close(T.apply(_t(A), _t(pts)), JT.apply(ja, tp), 1e-5)
    xi = _xi(32, 4, 0.1)
    _close(T.retract(_t(A), _t(xi)), JT.retract(ja, jnp.asarray(xi)), 1e-5)
    _close(T.retract_left(_t(A), _t(xi)), JT.retract_left(ja, jnp.asarray(xi)), 1e-5)
    _close(T.from_rt(_t(A[:, :, :3]), _t(A[:, :, 3])), JT.from_rt(ja[:, :, :3], ja[:, :, 3]), 0)
    noisy = A + np.random.default_rng(5).normal(0, 1e-3, A.shape).astype(np.float32)
    _close(T.orthonormalize(_t(noisy)), JT.orthonormalize(jnp.asarray(noisy)), 1e-6)
    assert torch.equal(T.identity(), _t(JT.identity()))


def _spd(n, dim, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, dim, dim)).astype(np.float32)
    return (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(dim, dtype=np.float32)).astype(np.float32)


def test_small_linalg():
    M = np.random.default_rng(6).normal(size=(64, 3, 3)).astype(np.float32)
    _close(L.inv3(_t(M)), JL.inv3(jnp.asarray(M)), 1e-4)
    _close(L.polar_so3(_t(M)), JL.polar_so3(jnp.asarray(M)), 1e-5)
    _close(L.det3(_t(M)), jnp.linalg.det(jnp.asarray(M)), 1e-5)
    A = _spd(32, 6, 7)
    b = np.random.default_rng(8).normal(size=(32, 6)).astype(np.float32)
    _close(L.chol_solve_unrolled(_t(A), _t(b)), JL.chol_solve_unrolled(jnp.asarray(A), jnp.asarray(b)), 1e-5)
    _close(L.chol_solve_unrolled(_t(A), _t(b), jitter=1e-3),
           JL.chol_solve_unrolled(jnp.asarray(A), jnp.asarray(b), jitter=1e-3), 1e-5)


def test_symmetric_eigen_with_fallbacks():
    S = _spd(64, 3, 9) / 4.0
    S[0] = np.diag([3.0, 1.0, 2.0])               # p1 < 1e-20: sorted diagonal
    S[1] = 2.0 * np.eye(3)                        # isotropic: +z eigenvector
    S[2] = np.diag([1.0, 0.0, 1.0])               # exactly rank-deficient
    lam = L.eig_sym3(_t(S))
    _close(lam, JL.eig_sym3(jnp.asarray(S)), 1e-5)
    lt, vt = L.eigvec_min_sym3(_t(S))
    lj, vj = JL.eigvec_min_sym3(jnp.asarray(S))
    _close(lt, lj, 1e-5)
    # eigenvectors: the same direction, up to sign
    dot = np.abs((vt.numpy() * np.asarray(vj)).sum(-1))
    assert dot.min() >= 1 - 1e-5
    np.testing.assert_array_equal(vt.numpy()[:2], np.asarray(vj)[:2])
    np.testing.assert_array_equal(vt.numpy()[1], [0.0, 0.0, 1.0])

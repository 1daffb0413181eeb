"""Epipolar geometry: every function of the port's ops/epipolar.py against
its JAX twin on the same numpy inputs, with the JAX twin's own RANSAC
samples injected (``indices=``), so both sides score the same hypotheses.

Data: a seeded calibrated two-view scene (points 3-8 m ahead, a known
relative motion), pixel or normalized coordinates with small noise and
a block of outlier correspondences; a planar scene for the homography.

Tolerances and why: inlier masks, cheirality masks and acceptance flags
exactly (integer outputs); the eight-point F solves in float32 are ill
conditioned (both packages land up to 4e-3 from the float64 solve, each
its own way), so a batch of them is held to the port's own per-sample
solves to 1e-6 and both packages to the float64 solve to 5e-3, and the
RANSAC's F to the twin's to 1e-3 after scaling to unit norm; E and H to 1e-4 after
scaling to unit norm and fixing the sign (SVD singular vectors are
defined up to sign, and LAPACK may pick another); poses to 1e-4 and
triangulated points to 1e-3 relative (float32 SVDs); the decomposition
candidates as unordered sets to 1e-4 (a sign choice in the SVD swaps the
two rotations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.ops import epipolar as JE
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.ops import epipolar as E
from torch_port_threads import one_torch_thread  # noqa: F401

F_PX = 300.0
CXY = np.array([160.0, 120.0], np.float32)


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def _scene(n=200, n_out=50, seed=0, planar=False):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 8, n) if not planar else 5.0 + 0.0 * rng.uniform(size=n)],
                 axis=1).astype(np.float32)
    R = _rot([0.02, -0.05, 0.01])
    t = np.array([0.3, 0.05, 0.1], np.float32)
    X2 = X @ R.T + t
    x1n, x2n = X[:, :2] / X[:, 2:3], X2[:, :2] / X2[:, 2:3]
    x2n = x2n + rng.normal(0, 2e-4, x2n.shape).astype(np.float32)
    x2n[:n_out] = rng.uniform(-0.4, 0.4, (n_out, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-7:] = False
    return x1n.astype(np.float32), x2n.astype(np.float32), valid


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(M, sign_fix=True):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    if sign_fix:
        k = np.argmax(np.abs(M))
        M = M * np.sign(M.flat[k])
    return M


def test_eight_point_and_sampson():
    x1n, x2n, _ = _scene(seed=1)
    u1, u2 = x1n * F_PX + CXY, x2n * F_PX + CXY
    rng = np.random.default_rng(1)
    idx = rng.integers(50, 200, (16, 8))
    Fj = np.asarray(JE._eight_point(jnp.asarray(u1[idx]), jnp.asarray(u2[idx])))
    Ft = E._eight_point(_t(u1[idx]), _t(u2[idx])).numpy()
    F64 = E._eight_point(_t(u1[idx]).double(), _t(u2[idx]).double()).numpy()
    for k in range(len(idx)):
        # the batch equals the port's own per-sample solve; float32 puts
        # both packages within 5e-3 of the float64 solve, sample by sample
        one = E._eight_point(_t(u1[idx[k]]), _t(u2[idx[k]])).numpy()
        np.testing.assert_allclose(_unit(Ft[k], False), _unit(one, False), atol=1e-6)
        for got in (Ft[k], Fj[k]):
            np.testing.assert_allclose(_unit(got, False), _unit(F64[k], False), atol=5e-3)
    dj = np.asarray(JE.sampson_distance(jnp.asarray(Fj[0]), jnp.asarray(u1), jnp.asarray(u2)))
    dt = E.sampson_distance(_t(Fj[0]), _t(u1), _t(u2)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_fundamental_and_check_hypothesis(seed):
    x1n, x2n, valid = _scene(seed=seed)
    u1, u2 = x1n * F_PX + CXY, x2n * F_PX + CXY
    key = jax.random.PRNGKey(seed)
    idx = _t(JR._sample_indices(key, jnp.asarray(valid), 128, 8))
    Fj, inl_j = JE.ransac_fundamental(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(valid), key)
    Ft, inl_t = E.ransac_fundamental(_t(u1), _t(u2), _t(valid), indices=idx)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(_unit(Ft.numpy(), False), _unit(Fj, False), atol=1e-3)
    assert int(inl_t.sum()) > 100
    for ratio in (0.0, 0.5, 0.9):
        okj, _, ij = JE.check_hypothesis(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(valid),
                                         key, inlier_ratio=ratio)
        okt, _, it = E.check_hypothesis(_t(u1), _t(u2), _t(valid), inlier_ratio=ratio,
                                        indices=idx)
        assert bool(okt) == bool(okj)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_ransac_fundamental_draws_from_a_generator():
    x1n, x2n, valid = _scene(seed=2)
    u1, u2 = _t(x1n * F_PX + CXY), _t(x2n * F_PX + CXY)
    a = E.ransac_fundamental(u1, u2, _t(valid), torch.Generator().manual_seed(5))
    b = E.ransac_fundamental(u1, u2, _t(valid), torch.Generator().manual_seed(5))
    assert torch.equal(a[1], b[1]) and int(a[1].sum()) > 100


def test_essential_from_pairs_refit_and_decompose():
    x1n, x2n, valid = _scene(seed=4)
    sel = np.arange(60, 68)
    Ej = np.asarray(JE.essential_from_pairs(jnp.asarray(x1n[sel]), jnp.asarray(x2n[sel])))
    Et = E.essential_from_pairs(_t(x1n[sel]), _t(x2n[sel])).numpy()
    np.testing.assert_allclose(_unit(Et), _unit(Ej), atol=1e-4)
    w = (np.arange(200) >= 50).astype(np.float32)
    Ej = np.asarray(JE.essential_refit(jnp.asarray(x1n), jnp.asarray(x2n), jnp.asarray(w)))
    Et = E.essential_refit(_t(x1n), _t(x2n), _t(w)).numpy()
    np.testing.assert_allclose(_unit(Et), _unit(Ej), atol=1e-4)
    Raj, Rbj, tj = (np.asarray(a) for a in JE.decompose_essential(jnp.asarray(Ej)))
    Rat, Rbt, tt = (a.numpy() for a in E.decompose_essential(_t(Ej)))
    for R in (Rat, Rbt):
        assert min(np.abs(R - Raj).max(), np.abs(R - Rbj).max()) < 1e-4
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < 1e-4


def test_triangulate_midpoint():
    x1n, x2n, _ = _scene(seed=5, n_out=0)
    R, t = _rot([0.02, -0.05, 0.01]), np.array([0.3, 0.05, 0.1], np.float32)
    Xj, z1j, z2j = (np.asarray(a) for a in JE.triangulate_midpoint(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1n), jnp.asarray(x2n)))
    Xt, z1t, z2t = (a.numpy() for a in E.triangulate_midpoint(_t(R), _t(t), _t(x1n), _t(x2n)))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(z2t, z2j, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(z1t > 1e-3, z1j > 1e-3)


def test_ransac_essential():
    x1n, x2n, valid = _scene(seed=6)
    key = jax.random.PRNGKey(6)
    idx = _t(JR._sample_indices(key, jnp.asarray(valid), 192, 8))
    Tj, inl_j, Xj, ok_j = (np.asarray(a) for a in JE.ransac_essential(
        jnp.asarray(x1n), jnp.asarray(x2n), jnp.asarray(valid), key, threshold=1e-3))
    Tt, inl_t, Xt, ok_t = (a.numpy() for a in E.ransac_essential(
        _t(x1n), _t(x2n), _t(valid), threshold=1e-3, indices=idx))
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(Xt[ok_t], Xj[ok_j], rtol=1e-3, atol=1e-3)
    assert inl_t.sum() > 120


def test_homography_functions():
    x1n, x2n, valid = _scene(seed=7, planar=True)
    key = jax.random.PRNGKey(7)
    Hj = np.asarray(JE.homography_from_pairs(jnp.asarray(x1n[60:64]), jnp.asarray(x2n[60:64])))
    Ht = E.homography_from_pairs(_t(x1n[60:64]), _t(x2n[60:64])).numpy()
    np.testing.assert_allclose(_unit(Ht), _unit(Hj), atol=1e-4)
    ej = np.asarray(JE.transfer_error(jnp.asarray(Hj), jnp.asarray(x1n), jnp.asarray(x2n)))
    et = E.transfer_error(_t(Hj), _t(x1n), _t(x2n)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-3, atol=1e-7)
    idx = _t(JR._sample_indices(key, jnp.asarray(valid), 192, 4))
    Hj, inl_j = JE.ransac_homography(jnp.asarray(x1n), jnp.asarray(x2n), jnp.asarray(valid),
                                     key, threshold=1e-3)
    Ht, inl_t = E.ransac_homography(_t(x1n), _t(x2n), _t(valid), threshold=1e-3, indices=idx)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(_unit(Ht.numpy()), _unit(np.asarray(Hj)), atol=1e-4)
    Rsj, tsj, nsj = (np.asarray(a) for a in JE.decompose_homography(
        Hj, jnp.asarray(x1n), jnp.asarray(x2n), inl_j))
    Rst, tst, nst = (a.numpy() for a in E.decompose_homography(
        _t(np.asarray(Hj)), _t(x1n), _t(x2n), _t(np.asarray(inl_j))))
    for k in range(4):
        assert min(np.abs(Rst[k] - Rsj[m]).max() + np.abs(tst[k] - tsj[m]).max()
                   + np.abs(nst[k] - nsj[m]).max() for m in range(4)) < 1e-3
    Tj, Xj, okj = (np.asarray(a) for a in JE.pose_from_homography(
        Hj, jnp.asarray(x1n), jnp.asarray(x2n), inl_j))
    Tt, Xt, okt = (a.numpy() for a in E.pose_from_homography(
        _t(np.asarray(Hj)), _t(x1n), _t(x2n), _t(np.asarray(inl_j))))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(Tt, Tj, atol=1e-3)

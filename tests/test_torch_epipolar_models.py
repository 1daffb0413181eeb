"""The calibrated two-view models of ``ops/epipolar.py``: the essential
matrix RANSAC and the homography functions (fit, transfer error, RANSAC,
decomposition, pose), the port against the JAX twin on the scenes and
with the tolerances of tests/test_torch_epipolar.py (E and H within 1e-4
after scaling to unit norm and fixing the sign; poses 1e-4; triangulated
points 1e-3 relative; the decomposition's candidates as unordered sets).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.ops import epipolar as JE
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.ops import epipolar as E
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_epipolar import _scene, _t, _unit  # noqa: F401


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

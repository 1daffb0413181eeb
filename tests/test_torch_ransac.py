"""RANSAC motion solvers: the port's ransac_rigid, _dlt_pnp, pnp_gn and
ransac_pnp against the JAX twins on the cases of tests/test_ransac.py,
with the JAX twin's own sample indices injected (``indices=``), so both
sides evaluate the same hypotheses.

Tolerances: inlier masks, inlier counts and the success flag exactly;
poses to 1e-4 (float32 solves summed in another order: the 12x12
inverse-iteration Cholesky, the 6x6 Gauss-Newton solves); covariances to
1e-3 relative (a quartile of squared distances, so it inherits the pose
error). The drawn samples themselves differ by design (``torch.randint``
on a generator against ``jax.random``); a separate test checks the
draws' contract: valid slots only, the shape, and the generator's
determinism."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import ransac as R
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = C.CameraModel.make(525.0, 525.0, 319.5, 239.5, 640, 480)
JCAM = JC.CameraModel.make(525.0, 525.0, 319.5, 239.5, 640, 480)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pnp_indices(key, valid, iters, with_query):
    if not with_query:
        return (JR._sample_indices(key, valid, iters, 6),)
    n_dlt = iters // 2
    return (JR._sample_indices(key, valid, n_dlt, 6),
            JR._sample_indices(jax.random.fold_in(key, 1), valid, iters - n_dlt, 3))


def _same_result(port, ref, pose_atol=1e-4):
    np.testing.assert_array_equal(port.inliers.numpy(), np.asarray(ref.inliers))
    assert int(port.num_inliers) == int(ref.num_inliers)
    assert bool(port.success) == bool(ref.success)
    np.testing.assert_allclose(port.transform.numpy(), np.asarray(ref.transform),
                               atol=pose_atol)
    np.testing.assert_allclose(port.covariance.numpy(), np.asarray(ref.covariance),
                               rtol=1e-3, atol=1e-9)


def test_ransac_rigid_with_outliers():
    key = jax.random.PRNGKey(1)
    k1, k2, k3, _ = jax.random.split(key, 4)
    n = 200
    pts = jax.random.uniform(k1, (n, 3), minval=-2.0, maxval=2.0) + jnp.array([0.0, 0.0, 5.0])
    gt = JT.from_xyzrpy(jnp.array([0.3, -0.1, 0.2, 0.05, -0.03, 0.1]))
    dst = JT.apply(gt[None], pts[None])[0] + 0.005 * jax.random.normal(k2, (n, 3))
    dst = dst.at[jnp.arange(60)].add(jax.random.uniform(k3, (60, 3), minval=-3, maxval=3))
    valid = jnp.ones((n,), bool)
    rkey = jax.random.PRNGKey(2)
    ref = jax.jit(JR.ransac_rigid)(pts, dst, valid, rkey)
    idx = JR._sample_indices(rkey, valid, 256, 3)
    port = R.ransac_rigid(_t(pts), _t(dst), _t(valid), indices=_t(idx))
    _same_result(port, ref)
    assert bool(port.success) and int(port.num_inliers) > 120


def test_dlt_pnp_exact_and_batched():
    key = jax.random.PRNGKey(3)
    pts = jax.random.uniform(key, (12, 3), minval=-2, maxval=2) + jnp.array([0.0, 0.0, 6.0])
    gt_wc = JT.from_xyzrpy(jnp.array([0.2, 0.1, -0.3, 0.1, -0.05, 0.2]))
    pc = JT.apply(JT.inverse(gt_wc)[None], pts[None])[0]
    xn = pc[:, :2] / pc[:, 2:3]
    ref = jax.jit(JR._dlt_pnp)(pts, xn)
    np.testing.assert_allclose(R._dlt_pnp(_t(pts), _t(xn)).numpy(), np.asarray(ref),
                               atol=1e-4)
    # a batch of 6-point minimal samples (the RANSAC hypotheses' form)
    # gives each sample's own solve; minimal samples are too ill-conditioned
    # in float32 to hold against the JAX twin sample by sample
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.permutation(12)[:6] for _ in range(16)]))
    batched = R._dlt_pnp(_t(pts)[idx], _t(xn)[idx])
    for k in range(16):
        np.testing.assert_allclose(batched[k].numpy(),
                                   R._dlt_pnp(_t(pts)[idx[k]], _t(xn)[idx[k]]).numpy(),
                                   atol=1e-6)


def test_pnp_gn_refines_like_the_twin():
    rng = np.random.default_rng(5)
    pts = (rng.uniform(-2, 2, (80, 3)) + [0, 0, 6]).astype(np.float32)
    gt = JT.inverse(JT.from_xyzrpy(jnp.array([0.1, -0.05, 0.2, 0.03, 0.02, -0.04])))
    pc = np.asarray(JT.apply(gt[None], jnp.asarray(pts)[None])[0])
    xn = (pc[:, :2] / pc[:, 2:3] + 0.001 * rng.normal(size=(80, 2))).astype(np.float32)
    w = (rng.random(80) > 0.2).astype(np.float32)
    T0 = np.asarray(JT.retract_left(gt, jnp.array([0.02, -0.01, 0.03, 0.01, 0.0, 0.02])))
    Tj, rj, dj = JR.pnp_gn(jnp.asarray(pts), jnp.asarray(xn), jnp.asarray(w), jnp.asarray(T0))
    Tp, rp, dp = R.pnp_gn(_t(pts), _t(xn), _t(w), _t(T0))
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=1e-5)


def _pnp_scene(seed, n, n_out, px_noise):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    pts = jax.random.uniform(k1, (n, 3), minval=-3, maxval=3) + jnp.array([0.0, 0.0, 8.0])
    gt_wc = JT.from_xyzrpy(jnp.array([0.15, -0.1, 0.3, 0.04, 0.08, -0.05]))
    pc = JT.apply(JT.inverse(gt_wc)[None], pts[None])[0]
    uv, z = JC.project(pc, JCAM)
    uv = uv + px_noise * jax.random.normal(k2, uv.shape)
    uv = uv.at[:n_out].add(jax.random.uniform(k3, (n_out, 2), minval=-80, maxval=80))
    valid = (z > 0) & JC.in_image(uv, 640, 480)
    return pts, uv, valid, pc, gt_wc


@pytest.mark.parametrize("with_query", [False, True], ids=["dlt", "dlt+kabsch"])
def test_ransac_pnp_with_outliers(with_query):
    pts, uv, valid, pc, gt_wc = _pnp_scene(4, 300, 90, 0.5)
    np.testing.assert_array_equal(C.in_image(_t(uv), 640, 480).numpy(),
                                  np.asarray(JC.in_image(uv, 640, 480)))
    q3 = jnp.where(jnp.arange(300)[:, None] % 7 == 0, 0.0, pc) if with_query else None
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, u, v, k, q: JR.ransac_pnp(p, u, v, JCAM, k, reproj_px=3.0,
                                                     pts3d_query=q))(pts, uv, valid, key, q3)
    port = R.ransac_pnp(_t(pts), _t(uv), _t(valid), CAM, reproj_px=3.0,
                        pts3d_query=None if q3 is None else _t(q3),
                        indices=tuple(_t(i) for i in _pnp_indices(key, valid, 256, with_query)))
    _same_result(port, ref)
    err = JT.se3_log(JT.relative(gt_wc, jnp.asarray(port.transform.numpy())))
    assert float(jnp.linalg.norm(err)) < 0.02
    assert float(port.inliers[:90].float().mean()) < 0.3


def test_ransac_pnp_with_guess_and_batch():
    """The guess joins the pool; a leading batch axis gives each item's
    unbatched result."""
    key = jax.random.PRNGKey(6)
    pts = jax.random.uniform(key, (100, 3), minval=-2, maxval=2) + jnp.array([0.0, 0.0, 5.0])
    gt_wc = JT.from_xyzrpy(jnp.array([0.05, 0.02, 0.1, 0.01, 0.02, -0.01]))
    pc = JT.apply(JT.inverse(gt_wc)[None], pts[None])[0]
    uv, z = JC.project(pc, JCAM)
    valid = z > 0
    rkey = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, u, v, k, q: JR.ransac_pnp(p, u, v, JCAM, k, iters=32,
                                                     guess=JT.identity(), pts3d_query=q))(
        pts, uv, valid, rkey, pc)
    idx = tuple(_t(i) for i in _pnp_indices(rkey, valid, 32, True))
    eye = torch.eye(3, 4)
    port = R.ransac_pnp(_t(pts), _t(uv), _t(valid), CAM, iters=32, guess=eye,
                        pts3d_query=_t(pc), indices=idx)
    _same_result(port, ref)
    err = JT.se3_log(JT.relative(gt_wc, jnp.asarray(port.transform.numpy())))
    assert float(jnp.linalg.norm(err)) < 5e-3
    b = lambda x: torch.stack([x, x])  # noqa: E731
    batched = R.ransac_pnp(b(_t(pts)), b(_t(uv)), b(_t(valid)), CAM, iters=32, guess=b(eye),
                           pts3d_query=b(_t(pc)), indices=tuple(b(i) for i in idx))
    for k in range(2):
        _same_result(R.RansacResult(*(x[k] for x in batched)), ref)

"""Pairwise registration, frame-to-keyframe odometry and the motion
filters: the port against the JAX twins on the same inputs.

register_frames: two 160x120 renders (fx = fy = 120) three steps apart on
``loop_trajectory(96)``, 128 GFTT/BRIEF keypoints extracted by the JAX
package and fed to both sides; PnP (type 1), 3D->3D Kabsch (type 0) and
PnP with the guess-projected window. OdometryF2F: tests/test_f2f_kalman.py's
short arc (``loop_trajectory(64)[:10]`` at 320x240, 384 keypoints). The
RANSAC: the JAX twin draws with its key (OdometryF2F splits it once a
frame); the port gets the twin's own samples for that key (``indices=``).
The Kalman filter: tests/test_f2f_kalman.py's constant-velocity run. The
particle filter: its random walk and resampling offsets drawn by
jax.random and injected.

Tolerances and why: match indices, flags, inlier masks and counts and the
keyframe decisions exactly; transforms and poses to 1e-4 (float32 PnP
and Kabsch sums in another order, compounded over the arc); the Kalman
state to 1e-5 relative (12x12 float32 products); the particle filter to
1e-5 (float32 sums of 500 weights in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.odometry import motion_filter as JMF
from rtabmap_tpu.odometry.f2f import OdometryF2F as JF2F
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.ops import registration as JREG
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.odometry import motion_filter as MF
from rtabmap_tpu_torch.odometry.f2f import OdometryF2F
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import registration as REG
from torch_port_threads import one_torch_thread  # noqa: F401

ITERS = 256   # register_frames' default
JCAM = JC.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)


def _features(jcam, poses, k):
    ex = jax.jit(lambda g, d: extract_features(g, d, jcam, k))
    return [tuple(np.asarray(x) for x in ex(*JS.render(jnp.asarray(p), jcam))) for p in poses]


def _port(f):
    return FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f))


def _jax(f):
    from rtabmap_tpu.core.frame import FrameFeatures as JFrame

    return JFrame(*(jnp.asarray(x) for x in f))


def _pnp_indices(key, valid, iters=ITERS):
    v = jnp.asarray(np.asarray(valid))
    return tuple(torch.from_numpy(np.array(x)) for x in (
        JR._sample_indices(key, v, iters // 2, 6),
        JR._sample_indices(jax.random.fold_in(key, 1), v, iters - iters // 2, 3)))


def _b_to_a_valid(a, b):
    """The B -> A match flags register_frames hands the RANSAC."""
    return M.match_nndr(b.desc, b.valid, a.desc, a.valid & a.valid3d).valid


@pytest.fixture(scope="module")
def pair():
    poses = np.asarray(JS.loop_trajectory(96))[[0, 3]]
    a, b = _features(JCAM, poses, 128)
    rel = np.linalg.inv(np.vstack([poses[0], [0, 0, 0, 1]])) @ np.vstack([poses[1], [0, 0, 0, 1]])
    return a, b, rel[:3].astype(np.float32)


def _same_registration(rp, rj):
    assert bool(rp.valid) == bool(rj.valid) and bool(rj.valid)
    assert int(rp.num_matches) == int(rj.num_matches)
    assert int(rp.num_inliers) == int(rj.num_inliers)
    np.testing.assert_array_equal(rp.match_idx.numpy(), np.asarray(rj.match_idx))
    np.testing.assert_array_equal(rp.inlier_mask.numpy(), np.asarray(rj.inlier_mask))
    np.testing.assert_allclose(rp.transform.numpy(), np.asarray(rj.transform), atol=1e-4)


@pytest.mark.parametrize("mode", ["pnp", "rigid", "window"])
def test_register_frames_matches_the_twin(pair, mode):
    a, b, rel = pair
    key = jax.random.PRNGKey(7)
    pa, pb = _port(a), _port(b)
    guess = rel if mode == "window" else None
    tg = None if guess is None else torch.from_numpy(guess)
    kw = {"estimation_type": 0 if mode == "rigid" else 1,
          "window": 30.0 if mode == "window" else 0.0}
    rj = jax.jit(lambda fa, fb, k, g: JREG.register_frames(fa, fb, JCAM, k, guess=g, **kw))(
        _jax(a), _jax(b), key, None if guess is None else jnp.asarray(guess))
    if mode == "rigid":
        v = jnp.asarray((_b_to_a_valid(pa, pb) & pb.valid3d).numpy())
        idx = (torch.from_numpy(np.array(JR._sample_indices(key, v, ITERS, 3))),)
    else:
        idx = _pnp_indices(key, _window_valid(pa, pb, tg, kw["window"]))
    rp = REG.register_frames(pa, pb, CAM, None, guess=tg, indices=idx, **kw)
    _same_registration(rp, rj)
    # the motion A -> B is near the ground truth's (128 keypoints at
    # 160x120; tests/test_f2f_kalman.py's bound on the arc's ATE)
    np.testing.assert_allclose(rp.transform.numpy()[:, 3], rel[:, 3], atol=0.06)


def _window_valid(a, b, guess, window):
    """The match flags after the window gate, as register_frames sets them."""
    from rtabmap_tpu_torch.geometry import transform as T

    m = M.match_nndr(b.desc, b.valid, a.desc, a.valid & a.valid3d)
    if guess is None or window <= 0.0:
        return m.valid
    uv_pred, _ = C.project(T.apply(T.inverse(guess), a.pts3d), CAM)
    du = uv_pred[m.idx.long()] - b.uv
    return m.valid & ((du * du).sum(-1) <= window * window)


def test_f2f_short_arc_matches_the_twin():
    jcam = JC.CameraModel.make(300.0, 300.0, 160.0, 120.0, 320, 240)
    cam = C.CameraModel.make(300.0, 300.0, 160.0, 120.0, 320, 240)
    n = 10
    gt = np.asarray(JS.loop_trajectory(64))[:n]
    feats = _features(jcam, gt, 384)
    jo = JF2F(jcam)
    po = OdometryF2F(cam, device="cpu")
    key = jax.random.PRNGKey(0)          # the twin's seed-0 key chain
    kfs = 0
    for i, f in enumerate(feats):
        fr = _port(f)
        idx = None
        if po.keyframe is not None:
            key, sub = jax.random.split(key)
            idx = _pnp_indices(sub, _b_to_a_valid(po.keyframe, fr))
        pj, cj, ij = jo.process(_jax(f))
        pp, cp, ip = po.process(fr, indices=idx)
        assert ip == ij, (i, ip, ij)
        assert pp is not None and pj is not None, i
        np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=1e-4, err_msg=str(i))
        kfs += ip["keyframe"]
    assert 1 < kfs < n                   # the keyframe was refreshed, not every frame
    # the odometry starts at the identity: its end against the true motion
    rel = np.linalg.inv(np.vstack([gt[0], [0, 0, 0, 1]])) @ np.vstack([gt[-1], [0, 0, 0, 1]])
    err = np.linalg.norm(po.pose.numpy()[:, 3] - rel[:3, 3])
    assert err < 0.06, err


def test_kalman_matches_the_twin():
    sj, sp = JMF.init_kalman(), MF.init_kalman(device="cpu")
    dt = 0.1
    true_v = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.2])
    rng = np.random.RandomState(0)
    for k in range(50):
        sj = JMF.kalman_predict(sj, dt, q=0.01)
        sp = MF.kalman_predict(sp, dt, q=0.01)
        meas = (true_v * (k + 1) * dt + 0.01 * rng.randn(6)).astype(np.float32)
        sj = JMF.kalman_update(sj, jnp.asarray(meas), jnp.eye(6) * 1e-4)
        sp = MF.kalman_update(sp, meas, np.eye(6, dtype=np.float32) * 1e-4)
        np.testing.assert_allclose(sp.x.numpy(), np.asarray(sj.x), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sp.P.numpy(), np.asarray(sj.P), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(MF.predicted_velocity(sp).numpy(), true_v, atol=0.08)
    np.testing.assert_allclose(MF.predicted_pose(sp).numpy(),
                               np.asarray(JMF.predicted_pose(sj)), atol=1e-5)


def test_particle_filter_matches_the_twin():
    key = jax.random.PRNGKey(0)
    sj = JMF.init_particles(key, n=500, dim=2, sigma=0.5)
    sp = MF.init_particles(n=500, dim=2, sigma=0.5,
                           noise=torch.from_numpy(np.array(jax.random.normal(key, (500, 2)))))
    np.testing.assert_array_equal(sp.particles.numpy(), np.asarray(sj.particles))
    rng = np.random.RandomState(1)
    target = np.array([0.3, -0.2])
    for k in range(30):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        meas = (target + 0.05 * rng.randn(2)).astype(np.float32)
        sj, ej = JMF.particle_step(sj, jnp.asarray(meas), sub)
        sp, ep = MF.particle_step(
            sp, meas, walk=torch.from_numpy(np.array(jax.random.normal(k1, (500, 2)))),
            offset=float(jax.random.uniform(k2)))
        np.testing.assert_allclose(ep.numpy(), np.asarray(ej), atol=1e-5)
    np.testing.assert_allclose(sp.particles.numpy(), np.asarray(sj.particles), atol=1e-5)
    np.testing.assert_allclose(ep.numpy(), target, atol=0.08)
    # the port's own draws track the target too
    g = torch.Generator().manual_seed(0)
    st = MF.init_particles(g, n=500, dim=2, sigma=0.5)
    for k in range(30):
        st, est = MF.particle_step(st, target + 0.05 * rng.randn(2), g)
    np.testing.assert_allclose(est.numpy(), target, atol=0.08)

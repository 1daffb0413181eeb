"""Monocular odometry and F2M's guess-projected window: the port against
the JAX twins on the same features, with the twins' own RANSAC samples
injected (``indices=``).

Frames: tests/test_odometry_mono.py's strafe (a lateral dolly with a
slight yaw) rendered at 160x120 (fx = fy = 160), 128 GFTT/BRIEF keypoints
extracted once by the JAX package and fed to both sides as the same numpy
arrays. ``_bootstrap`` runs on frames 0 and 6 (known motion); the
OdometryMono run on the first 9 frames, ``OdomMono/InitMinFlow`` 8 and
``Vis/MinInliers`` 12 as in the twin test (it bootstraps, tracks, runs the
local BA and triangulates new landmarks). The JAX twin splits its seed-0
key once a frame, and the bootstrap's key once more (essential, then
homography samples). F2M: frames of ``loop_trajectory(96)`` through
``odom_step`` with ``search_window`` 40 px.

Tolerances and why: match indices and flags, inlier counts, the
bootstrap's point flags, the landmark count and flags exactly; the
bootstrap's T21 to 1e-3 and its points (up to 10 baselines away) to
1e-3 relative: here the homography wins (58 inliers
against the essential matrix's 59), and its decomposition of a
near-rotation (singular values of H^T H within a few 1e-3 of each other)
amplifies the last-bit differences of the two float32 SVDs; the two-view
BA then shrinks the free scale about 8-fold before the baseline is set
back to 1, scaling those differences up again (before the BA, the
essential path's T21 agrees to 1.2e-6, and the BA alone, from the same
inputs, to 1.1e-7). Tracked poses and landmarks to 1e-3 for the same
reason (they inherit the bootstrap's map; landmarks relative); F2M as
tests/test_torch_odometry_f2m.py holds it (poses 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FrameFeatures as JFrame, extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.odometry import f2m as JF2M
from rtabmap_tpu.odometry import mono as JMO
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.odometry import f2m as F2M
from rtabmap_tpu_torch.odometry import mono as MO
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

K, N, ITERS = 128, 9, 192
JCAM = JC.CameraModel.make(160.0, 160.0, 79.5, 59.5, 160, 120)
CAM = C.CameraModel.make(160.0, 160.0, 79.5, 59.5, 160, 120)
MONO_P = {"OdomMono/InitMinFlow": 8.0, "Vis/MinInliers": 12}


def strafe(n, step=0.06, yaw_per_step=0.004):
    """tests/test_odometry_mono.py's trajectory."""
    poses = []
    for i in range(n):
        R = np.asarray(JT.so3_exp(jnp.asarray([0.0, yaw_per_step * i, 0.0])))
        t = np.array([[step * i], [0.0], [0.0]], np.float32)
        poses.append(np.concatenate([R.astype(np.float32), t], axis=1))
    return np.stack(poses)


@pytest.fixture(scope="module")
def frames():
    poses = strafe(N)
    grays, _ = JS.render_sequence(jnp.asarray(poses), JCAM)
    ext = jax.jit(lambda g: extract_features(g, jnp.zeros_like(g), JCAM, K))
    return poses, [tuple(np.asarray(x) for x in ext(g)) for g in grays]


def _port(f):
    return FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f))


def _jax(f):
    return JFrame(*(jnp.asarray(x) for x in f))


def _draws(key, valid, n_pts):
    return torch.from_numpy(np.array(JR._sample_indices(key, jnp.asarray(valid.numpy()),
                                                        ITERS, n_pts)))


def _bootstrap_indices(key, kf, fr):
    ke, kh = jax.random.split(key)
    v = M.match_mutual_nndr(kf.desc, kf.valid, fr.desc, fr.valid).valid
    return _draws(ke, v, 8), _draws(kh, v, 4)


def test_bootstrap_known_motion(frames):
    poses, feats = frames
    kf, fr = feats[0], feats[6]
    key = jax.random.PRNGKey(4)
    thr = float(np.float32(2.0 / 160.0))
    jout = JMO._bootstrap(_jax(kf), _jax(fr), JCAM, key, jnp.float32(0.8), jnp.float32(thr))
    pout = MO._bootstrap(_port(kf), _port(fr), CAM, None, 0.8, thr,
                         indices=_bootstrap_indices(key, _port(kf), _port(fr)))
    flow_j, T21_j, n_j, X_j, ok_j, idx_j = (np.asarray(x) for x in jout)
    flow_p, T21_p, n_p, X_p, ok_p, idx_p = (x.numpy() for x in pout)
    np.testing.assert_array_equal(idx_p, idx_j)
    assert int(n_p) == int(n_j) and int(n_j) >= 30
    np.testing.assert_array_equal(ok_p, ok_j)
    np.testing.assert_allclose(flow_p, flow_j, rtol=1e-5)
    np.testing.assert_allclose(T21_p, T21_j, atol=1e-3)
    np.testing.assert_allclose(X_p[ok_p], X_j[ok_j], rtol=1e-3, atol=1e-3)
    # the known motion: cam 6 in cam 0 is a strafe along +x with a small
    # yaw; T21 maps cam-0 points into cam 6, unit baseline
    rel = np.linalg.inv(np.vstack([poses[0], [0, 0, 0, 1]])) @ np.vstack([poses[6], [0, 0, 0, 1]])
    t_true = -(rel[:3, :3].T @ rel[:3, 3])
    assert float(T21_p[:, 3] @ (t_true / np.linalg.norm(t_true))) > 0.95


def test_mono_strafe_matches_the_twin(frames):
    poses, feats = frames
    jo = JMO.OdometryMono(JCAM, JParameters(MONO_P), seed=0)
    po = MO.OdometryMono(CAM, Parameters(MONO_P), device="cpu")
    key = jax.random.PRNGKey(0)            # the twin's seed-0 key chain
    tracked, ba_runs = 0, 0
    for i, f in enumerate(feats):
        fr = _port(f)
        idx = None
        if po.keyframe is not None:
            key, sub = jax.random.split(key)
            if not po.initialized:
                idx = _bootstrap_indices(sub, po.keyframe, fr)
            else:
                m = M.match_nndr(fr.desc, fr.valid, po.map_desc, po.map_valid)
                idx = (_draws(sub, m.valid, 6),)
        pj, cj, ij = jo.process(_jax(f))
        pp, cp, ip = po.process(fr, indices=idx)
        assert set(ip) == set(ij), i
        for k in ("matches", "inliers", "initialized", "landmarks"):
            assert ip.get(k) == ij.get(k), (i, k, ip, ij)
        if "flow" in ij:
            np.testing.assert_allclose(ip["flow"], ij["flow"], rtol=1e-5)
        assert (pp is None) == (pj is None), i
        if pj is not None:
            np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=1e-3, err_msg=str(i))
            tracked += 1
        ba_runs += len(po._window) >= 3
        assert po.n_landmarks == jo.n_landmarks
        np.testing.assert_array_equal(po.map_valid.numpy(), np.asarray(jo.map_valid))
        np.testing.assert_array_equal(po.map_desc.numpy(), np.asarray(jo.map_desc))
        np.testing.assert_allclose(po.map_xyz.numpy(), np.asarray(jo.map_xyz), rtol=1e-3,
                                   atol=1e-3)
    assert po.initialized and tracked >= 3 and ba_runs >= 1 and po.n_landmarks > 50


def test_f2m_search_window_matches_the_twin():
    jcam = JC.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
    cam = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
    ex = jax.jit(lambda g, d: extract_features(g, d, jcam, K))
    feats = [tuple(np.asarray(x) for x in ex(*JS.render(jnp.asarray(p), jcam)))
             for p in np.asarray(JS.loop_trajectory(96))[:4]]
    jstep = jax.jit(lambda st, fr, key: JF2M.odom_step(st, fr, jcam, key, reproj_px=2.0,
                                                       ransac_iters=ITERS, search_window=40.0))
    js = JF2M.init_state(200, ba_frames=3, obs_capacity=K)
    ps = F2M.init_state(200, ba_frames=3, obs_capacity=K, device="cpu")
    from rtabmap_tpu_torch.geometry import transform as T

    for i, f in enumerate(feats):
        key = jax.random.PRNGKey(100 + i)
        pf = _port(f)
        idx = None
        if ps.initialized:
            guess = T.compose(ps.pose, T.se3_exp(ps.vel))
            uv, z = C.project(T.apply(T.inverse(guess), ps.map_pts), cam)
            vis = ps.map_valid & (z > 0.05) & C.in_image(uv, 160, 120, -40.0)
            m = M.match_nndr(pf.desc, pf.valid, ps.map_desc, vis)
            du = uv[m.idx.long()] - pf.uv
            v = jnp.asarray((m.valid & ((du * du).sum(-1) <= 1600.0)).numpy())
            idx = tuple(torch.from_numpy(np.array(x)) for x in (
                JR._sample_indices(key, v, ITERS // 2, 6),
                JR._sample_indices(jax.random.fold_in(key, 1), v, ITERS - ITERS // 2, 3)))
        js, jr = jstep(js, JF2M.FrameFeatures(*(jnp.asarray(x) for x in f)), key)
        ps, pr = F2M.odom_step(ps, pf, cam, reproj_px=2.0, ransac_iters=ITERS,
                               search_window=40.0, indices=idx)
        assert pr.success == bool(jr.success) and pr.success, i
        assert pr.num_matches == int(jr.num_matches)
        assert pr.num_inliers == int(jr.num_inliers)
        assert pr.keyframe_added == bool(jr.keyframe_added)
        np.testing.assert_allclose(ps.pose.numpy(), np.asarray(js.pose), atol=1e-4)
        np.testing.assert_array_equal(ps.map_valid.numpy(), np.asarray(js.map_valid))
    assert pr.num_matches > 20

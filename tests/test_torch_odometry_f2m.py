"""Frame-to-map visual odometry: the port's odom_step, _insert_keyframe and
local_ba_step against the JAX twins, tick by tick, on the same features.

Six 160x120 renders (fx = fy = 120) along ``loop_trajectory(96)`` (3.75
degrees a frame), 128 GFTT/BRIEF keypoints extracted once by the JAX
package and fed to both sides as the same numpy arrays, a keyframe
threshold of 0.8 (a keyframe on most ticks), a 200-point map (so the
oldest-first cull runs from the third keyframe on) and a 3-keyframe BA
window (so the ring wraps). RANSAC: the JAX twin draws with its key; the port gets the JAX
twin's own samples for that key (``indices=``).

Tolerances and why: match indices and flags, inlier counts, keyframe
decisions, the map's flags, ids, descriptors, seen-stamps and slot order,
and the BA window's observation ids exactly; poses, map points and
velocities to 1e-4 (float32 PnP and BA sums in another order; the BA
point blocks are atomically summed on the card); the odometry covariance
as ``_same_covariance`` says."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.odometry import f2m as JF
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.odometry import f2m as F
from rtabmap_tpu_torch.ops import matching as M
from torch_port_threads import one_torch_thread  # noqa: F401

N_FRAMES, K, MAP, BA_FRAMES = 6, 128, 200, 3
JCAM = JC.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
ITERS, REPROJ, KF_THR = 192, 2.0, 0.8


@pytest.fixture(scope="module")
def frames():
    ex = jax.jit(lambda g, d: extract_features(g, d, JCAM, K))
    out = []
    for pose in np.asarray(JS.loop_trajectory(96))[:N_FRAMES]:
        g, d = JS.render(jnp.asarray(pose), JCAM)
        out.append(tuple(np.asarray(x) for x in ex(g, d)))
    return out


def _port_frame(f):
    return FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f))


def _indices(key, match_valid):
    v = jnp.asarray(match_valid.numpy())
    return (torch.from_numpy(np.asarray(JR._sample_indices(key, v, ITERS // 2, 6))),
            torch.from_numpy(np.asarray(JR._sample_indices(jax.random.fold_in(key, 1), v,
                                                           ITERS - ITERS // 2, 3))))


def _same_covariance(p, j):
    """Linear block to 1e-3 relative; the angular block to 0.2 relative:
    it is 2.1981 x the lower quartile of arccos(cosine) over the inliers,
    and arccos of a float32 cosine within 1e-6 of 1 moves by up to
    ~3.5e-4 rad with the cosine's last bit (angles here are ~1e-3 rad)."""
    np.testing.assert_allclose(p[:3, :3], j[:3, :3], rtol=1e-3)
    np.testing.assert_allclose(p[3:, 3:], j[3:, 3:], rtol=0.2)
    assert not p[:3, 3:].any() and not p[3:, :3].any()


def _last_write_differs(state):
    """Map slots where the JAX twin's ``touched.at[slot].set(ok)`` (several
    observations per slot: unresolved ones all land on slot 0; on the CPU
    the last write wins) differs from "any ok observation", the intent the
    port implements. Only slot 0 can differ; the JAX twin then drops that
    point's BA refinement (ROADMAP section 3)."""
    obs = state.obs_ids.numpy().reshape(-1)
    Kw = state.obs_ids.shape[1]
    eq = (obs[:, None] == state.map_ids.numpy()[None, :]) & state.map_valid.numpy()[None, :]
    slot = eq.argmax(1)
    ok = eq.any(1) & (obs >= 0) & state.kf_valid.numpy()[np.arange(obs.size) // Kw]
    any_ok = np.bincount(slot, ok, minlength=eq.shape[1]) > 0
    last = np.zeros_like(any_ok)
    last[slot] = ok                       # numpy fancy assignment: last write wins
    differs = np.nonzero(any_ok != last)[0]
    assert set(differs.tolist()) <= {0}
    return differs


def _same_state(p, j, atol=1e-4, skip_pts=()):
    keep = np.ones(p.map_pts.shape[0], bool)
    keep[list(skip_pts)] = False
    np.testing.assert_allclose(p.map_pts.numpy()[keep], np.asarray(j.map_pts)[keep],
                               atol=atol, err_msg="map_pts")
    for name in ("map_valid", "map_ids", "map_desc", "map_seen", "obs_ids", "kf_valid",
                 "kf_stamp", "next_id"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("pose", "vel", "kf_poses", "obs_uv"):
        np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=atol, err_msg=name)
    assert p.kf_count == float(j.kf_count) and p.kf_ptr == int(j.kf_ptr)
    assert p.initialized == bool(j.initialized) and p.age == float(j.age)


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX twin's jitted tick and local BA at this module's settings
    (compiled once for the module's tests)."""
    return (jax.jit(lambda st, fr, key: JF.odom_step(st, fr, JCAM, key, reproj_px=REPROJ,
                                                     ransac_iters=ITERS, keyframe_thr=KF_THR)),
            jax.jit(lambda st: JF.local_ba_step(st, JCAM)))


def test_odom_step_keyframes_and_local_ba(frames, jax_fns):
    jstep, jba = jax_fns
    js = JF.init_state(MAP, ba_frames=BA_FRAMES, obs_capacity=K)
    ps = F.init_state(MAP, ba_frames=BA_FRAMES, obs_capacity=K, device="cpu")
    n_kf = n_ba = 0
    for i, f in enumerate(frames):
        key = jax.random.PRNGKey(100 + i)
        pf = _port_frame(f)
        idx = None
        if ps.initialized:
            m = M.match_nndr(pf.desc, pf.valid, ps.map_desc, ps.map_valid)
            jm = JF.M.match_nndr(jnp.asarray(f[1]), jnp.asarray(f[3]), js.map_desc,
                                 js.map_valid)
            np.testing.assert_array_equal(m.idx.numpy(), np.asarray(jm.idx))
            np.testing.assert_array_equal(m.valid.numpy(), np.asarray(jm.valid))
            idx = _indices(key, m.valid)
        js, jr = jstep(js, JF.FrameFeatures(*(jnp.asarray(x) for x in f)), key)
        ps, pr = F.odom_step(ps, pf, CAM, reproj_px=REPROJ, ransac_iters=ITERS,
                              keyframe_thr=KF_THR, indices=idx)
        assert pr.success == bool(jr.success)
        assert pr.num_matches == int(jr.num_matches)
        assert pr.num_inliers == int(jr.num_inliers)
        assert pr.keyframe_added == bool(jr.keyframe_added)
        _same_covariance(pr.covariance.numpy(), np.asarray(jr.covariance))
        _same_state(ps, js)
        n_kf += pr.keyframe_added
        if pr.keyframe_added:
            differs = _last_write_differs(ps)
            js, ps = jba(js), F.local_ba_step(ps, CAM)
            n_ba += min(ps.kf_ptr, BA_FRAMES) >= 2
            _same_state(ps, js, skip_pts=differs)
            # later ticks start from the JAX twin's map, so a dropped
            # refinement does not propagate into the comparison
            ps = ps._replace(map_pts=torch.from_numpy(np.array(js.map_pts)))
    assert n_kf >= 4 and n_ba >= 2        # the cull and the window wrap ran
    assert bool(ps.map_valid.all())


def test_insert_keyframe_cull_order_with_ties(frames):
    """A full map whose seen-stamps tie across many slots: the port keeps
    the JAX twin's slots in the JAX twin's order (lax.top_k keeps the lower
    index among equals)."""
    js = JF.init_state(MAP, ba_frames=BA_FRAMES, obs_capacity=K)
    rng = np.random.default_rng(0)
    seen = rng.integers(1, 4, MAP).astype(np.float32)          # 3 values: ties
    js = js._replace(map_valid=jnp.ones((MAP,), bool), map_seen=jnp.asarray(seen),
                     map_ids=jnp.arange(MAP, dtype=jnp.int32), kf_count=jnp.float32(3.0),
                     next_id=jnp.int32(MAP), kf_ptr=jnp.int32(3),
                     map_pts=jnp.asarray(rng.normal(size=(MAP, 3)).astype(np.float32)))
    ps = F.init_state(MAP, ba_frames=BA_FRAMES, obs_capacity=K, device="cpu")._replace(
        map_valid=torch.ones(MAP, dtype=torch.bool), map_seen=torch.from_numpy(seen),
        map_ids=torch.arange(MAP, dtype=torch.int32), kf_count=3.0,
        next_id=torch.tensor(MAP, dtype=torch.int32), kf_ptr=3,
        map_pts=torch.from_numpy(np.asarray(js.map_pts)))
    f = frames[1]
    idx = rng.integers(0, MAP, K).astype(np.int32)
    ok = rng.random(K) < 0.3
    pose = np.eye(3, 4, dtype=np.float32)
    jn = JF._insert_keyframe(js, JF.FrameFeatures(*(jnp.asarray(x) for x in f)),
                             jnp.asarray(pose), jnp.asarray(idx), jnp.asarray(ok))
    pn = F._insert_keyframe(ps, _port_frame(f), torch.from_numpy(pose), torch.from_numpy(idx),
                            torch.from_numpy(ok))
    _same_state(pn._replace(kf_ptr=pn.kf_ptr), jn._replace(initialized=False,
                                                          age=jnp.float32(0.0)))


def test_odometry_wrapper_runs_and_loses_on_garbage(frames):
    odom = F.OdometryF2M(CAM, device="cpu")
    for f in frames[:3]:
        pose, cov, info = odom.process(_port_frame(f))
        assert pose is not None and bool(torch.isfinite(cov).all())
    junk = _port_frame(frames[3])._replace(
        desc=torch.from_numpy(np.where(np.random.default_rng(1).random((K, 256)) < 0.5, 1, -1)
                              .astype(np.int8)))
    pose, cov, info = odom.process(junk)
    assert pose is None and float(cov[0, 0]) >= 9999.0 and odom.lost
    # with an IMU orientation the tracked pose takes its roll and pitch
    q = np.array([0.05, -0.03, 0.4, 0.9], np.float32)
    q /= np.linalg.norm(q)
    pose, cov, info = odom.process(_port_frame(frames[4]), imu_quat=q)
    rpy = T.to_xyzrpy(pose).numpy()
    rpy_q = T.to_xyzrpy(T.from_quaternion(torch.from_numpy(q))).numpy()
    np.testing.assert_allclose(rpy[3:5], rpy_q[3:5], atol=1e-5)
    np.testing.assert_array_equal(odom.pose.numpy(), pose.numpy())
    # the guess-projected window (held to its twin in
    # tests/test_torch_odometry_mono.py) runs from the wrapper's state
    st, res = F.odom_step(odom.state, _port_frame(frames[4]), CAM, search_window=40.0)
    assert res.success and res.num_matches > 0


def test_odometry_with_imu_quat_matches_the_twin(frames, jax_fns):
    """OdometryF2M.process(frame, imu_quat) through both wrappers, the JAX
    twin's draws injected: each tracked pose (after the local BA) takes the
    IMU's roll and pitch. The IMU orientation is the true rotation since
    the first frame, tilted by a few mrad."""
    from rtabmap_tpu.odometry import imu_filter as JIMU  # noqa: F401 (compiled below)
    from rtabmap_tpu.utils.params import Parameters as JParameters
    from rtabmap_tpu_torch.utils.params import Parameters

    settings = {"Odom/KeyFrameThr": KF_THR, "OdomF2M/MaxSize": MAP, "Vis/MaxFeatures": K,
                "OdomF2M/BundleAdjustmentMaxFrames": BA_FRAMES, "Vis/PnPReprojError": REPROJ}
    jo = JF.OdometryF2M(JCAM, JParameters(settings))
    jo._step, jo._ba = jax_fns                  # the same computation, compiled once
    po = F.OdometryF2M(CAM, Parameters(settings), device="cpu")
    poses = np.asarray(JS.loop_trajectory(96))[:N_FRAMES]
    rng = np.random.default_rng(9)
    for i, f in enumerate(frames):
        rel = T.np_relative(poses[0], poses[i]).astype(np.float32)
        tilt = T.from_xyzrpy(torch.tensor([0, 0, 0, *rng.normal(0, 0.003, 2), 0.0],
                                          dtype=torch.float32))
        q = T.to_quaternion(T.compose(torch.from_numpy(rel), tilt)).numpy()
        _, sub = jax.random.split(jo._key)      # the key the twin's process draws with
        pf = _port_frame(f)
        idx = None
        if po.state.initialized:
            idx = _indices(sub, M.match_nndr(pf.desc, pf.valid, po.state.map_desc,
                                             po.state.map_valid).valid)
        jpose, _, jinfo = jo.process(JF.FrameFeatures(*(jnp.asarray(x) for x in f)),
                                     imu_quat=q)
        ppose, _, pinfo = po.process(pf, imu_quat=q, indices=idx)
        assert pinfo == {k: type(pinfo[k])(v) for k, v in jinfo.items()}
        assert (ppose is None) == (jpose is None) and ppose is not None
        np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), atol=1e-4)
        rp = T.to_xyzrpy(ppose).numpy()[3:5]
        np.testing.assert_allclose(rp, T.to_xyzrpy(T.from_quaternion(torch.from_numpy(q)))
                                   .numpy()[3:5], atol=1e-5)
        # later ticks start from the twin's map (as in the tick test above)
        po.state = po.state._replace(map_pts=torch.from_numpy(np.array(jo.state.map_pts)))

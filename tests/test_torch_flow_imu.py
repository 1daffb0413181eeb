"""KLT flow, the Vis/CorType 1 registration and the IMU filters: the port
against the JAX twins on the CPU, on the same seeded numpy inputs (frames
rendered once by the port's renderer, keypoints and 3D extracted once by
the port, fed to both sides as the same arrays).

Tolerances and why: tracked positions to 1e-4 px (float32 patch sums in
another order over the Gauss-Newton steps), except at most 5% of the
points, whose eight steps a level end before the iteration settles, so an
ulp's difference in the pyramid or a sum carries on: those to 5e-4 px
(measured: 3 of 94 points past 1e-4 px, the largest 2.6e-4 px); ``ok`` masks equal except at
points whose gated value lies within 1e-4 relative of its threshold
(counted, held small); the registration's transform to 1e-4 and its
counts exactly, with the JAX twin's RANSAC samples injected
(``indices=``); quaternions and aligned poses to 2e-6 (float32 products
in another order; 64 sequential updates) and 1e-5 for poses rebuilt from
Euler angles (sin/cos of float32 angles).
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

K, ITERS = 128, 256
ARGS = (120.0, 120.0, 80.0, 60.0, 160, 120)
CAM, JCAM = C.CameraModel.make(*ARGS), JC.CameraModel.make(*ARGS)
REL = 1e-4


@pytest.fixture(scope="module")
def frames():
    """Three renders 3.75 degrees apart with their features."""
    out = []
    for pose in loop_trajectory(96)[:3]:
        g, d = render(pose, CAM, device="cpu")
        f = extract_features(g, d, CAM, K)
        out.append({"gray": g.numpy(), "pose": pose, "uv": f.uv.numpy(),
                    "desc": f.desc.numpy(), "pts3d": f.pts3d.numpy(),
                    "valid3d": (f.valid3d & f.valid).numpy()})
    return out


def _near(value, threshold):
    return np.abs(value - threshold) <= REL * max(abs(threshold), 1e-3)


def _rms_j(prev, nxt, uv, uv2):
    offs = JFL._lk_offsets(3)
    res = (JFL._patch_sample(jnp.asarray(prev), jnp.asarray(uv), offs)
           - JFL._patch_sample(jnp.asarray(nxt), jnp.asarray(uv2), offs))
    return np.sqrt(np.mean(np.asarray(res) ** 2, -1))


@pytest.mark.parametrize("guess", [False, True], ids=["no-guess", "guess"])
def test_klt_track_matches_the_twin(frames, guess):
    a, b = frames[0], frames[2]
    uv, valid = a["uv"], a["valid3d"]
    g = None
    if guess:   # A's 3D projected into B under the true motion
        rel = T.np_relative(b["pose"], a["pose"]).astype(np.float32)
        xb = a["pts3d"] @ rel[:, :3].T + rel[:, 3]
        g = np.stack([xb[:, 0] / xb[:, 2] * 120 + 80, xb[:, 1] / xb[:, 2] * 120 + 60],
                     -1).astype(np.float32)
        g = np.where(valid[:, None], g, uv)
    uv2_p, ok_p = FL.klt_track(*(torch.from_numpy(x) for x in (a["gray"], b["gray"], uv, valid)),
                               guess_uv=None if g is None else torch.from_numpy(g))
    uv2_j, ok_j = JFL.klt_track(*(jnp.asarray(x) for x in (a["gray"], b["gray"], uv, valid)),
                                guess_uv=None if g is None else jnp.asarray(g))
    uv2_p, ok_p, uv2_j, ok_j = uv2_p.numpy(), ok_p.numpy(), np.asarray(uv2_j), np.asarray(ok_j)
    both = ok_p & ok_j
    assert both.sum() >= 0.5 * valid.sum()
    err = np.abs(uv2_p - uv2_j).max(-1)[both]
    assert (err > 1e-4).sum() <= 0.05 * both.sum(), np.sort(err)[-8:]
    assert err.max() <= 5e-4, err.max()
    rms = _rms_j(a["gray"], b["gray"], uv, uv2_j)
    move = np.linalg.norm(uv2_j - uv, axis=-1)
    near = (_near(rms, 0.08) | _near(move, 100.0) | _near(uv2_j[:, 0], 0.0)
            | _near(uv2_j[:, 0], 159.0) | _near(uv2_j[:, 1], 0.0) | _near(uv2_j[:, 1], 119.0))
    assert not ((ok_p != ok_j) & ~near).any()
    assert int(((ok_p != ok_j) & near).sum()) <= 2      # near-threshold flips
    # the tracks land where the scene moved: against the guess's projection
    if guess:
        assert np.median(np.linalg.norm(uv2_p[both] - g[both], axis=-1)) < 0.5


def _memories(frames, cor_type):
    jm = JMEM.Memory(JParameters({"Tpu/VocabularyCapacity": 1024, "Vis/CorType": cor_type}),
                     node_capacity=8, words_per_frame=K)
    pm = MEM.Memory(Parameters({"Tpu/VocabularyCapacity": 1024, "Vis/CorType": cor_type}),
                    node_capacity=8, words_per_frame=K, device="cpu")
    for i, s in enumerate(frames):
        for mem, Sig in ((jm, JMEM.Signature), (pm, MEM.Signature)):
            mem.signatures[i + 1] = Sig(id=i + 1, map_id=0, stamp=float(i), pose=s["pose"],
                                        desc=s["desc"], uv=s["uv"], pts3d=s["pts3d"],
                                        valid3d=s["valid3d"], image=s["gray"])
    return jm, pm


def test_flow_registration_matches_the_twin(frames):
    """Vis/CorType 1 with a guess (the proximity and odometry-cache case):
    A's keypoints KLT-tracked into B's image from their projection, then
    PnP-RANSAC (no query 3D; the guess joins the pool) with the twin's
    samples for its key. A track that flips near the rms gate may change
    the match count and the inliers by one each."""
    jm, pm = _memories(frames, 1)
    a, b = frames[0], frames[2]
    rel = T.np_relative(a["pose"], b["pose"]).astype(np.float32)
    valid = jnp.asarray(a["valid3d"])
    xb = JT.apply(JT.inverse(jnp.asarray(rel))[None], jnp.asarray(a["pts3d"])[None])[0]
    uvp, z = JC.project(xb, JCAM)
    g_uv = jnp.where((z > 0)[:, None], uvp, jnp.asarray(a["uv"]))
    # the twin's correspondence flags, for its RANSAC samples
    uv_b, ok = JFL.klt_track(jnp.asarray(a["gray"]), jnp.asarray(b["gray"]),
                             jnp.asarray(a["uv"]), valid, guess_uv=g_uv,
                             win=max(jm.flow_win_size // 2, 2), iters=jm.flow_iterations,
                             levels=1, max_move=1e9)
    w = valid & ok & (uv_b[:, 0] >= 0) & (uv_b[:, 0] < 160) & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < 120)
    key = jax.random.PRNGKey(5)
    idx = (torch.from_numpy(np.array(JR._sample_indices(key, w, ITERS, 6))),)
    ref = jm.compute_transform(1, 3, JCAM, key, guess=rel)
    got = pm.compute_transform(1, 3, CAM, guess=rel, indices=idx)
    flips = abs(pm.last_registration["matches"] - jm.last_registration["matches"])
    assert flips <= 1 and jm.last_registration["matches"] >= 40
    assert abs(got[2] - ref[2]) <= flips and got[2] >= 20
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-4)
    true = T.np_relative(a["pose"], b["pose"])     # the motion found: the true one, to 5 cm
    assert np.abs(got[0] - true).max() < 0.05
    # the batched form registers each pair on its own, the same way
    handles = pm.compute_transform_batch_async([1], 3, CAM, None, [rel],
                                               indices=tuple(x[None] for x in idx))
    (batched,) = pm.collect_transform_batch(handles)
    np.testing.assert_array_equal(batched[0], got[0])


def _imu_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    accel = (np.array([0.3, -0.4, 9.81]) + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    dt = rng.uniform(0.002, 0.01, n).astype(np.float32)
    dt[-8:] = 0.0                                     # the padding the twin adds
    accel[-8:] = gyro[-8:] = 0.0
    q0 = rng.normal(size=4).astype(np.float32)
    return gyro, accel, dt, q0 / np.linalg.norm(q0)


def test_engine_keeps_images_for_flow_correspondences(frames):
    """With Vis/CorType 1 the engine keeps each node's image from ``raw``
    (the twin's engine alike); without ``raw`` the node has none and
    registers by descriptors."""
    from rtabmap_tpu_torch.core.frame import FrameFeatures
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap

    slam = Rtabmap(CAM, Parameters({"Vis/CorType": 1, "Tpu/VocabularyCapacity": 4096}),
                   node_capacity=8, words_per_frame=K, device="cpu")
    for i, f in enumerate(frames):
        g, d = render(f["pose"], CAM, device="cpu")
        feat = extract_features(g, d, CAM, K)
        assert isinstance(feat, FrameFeatures)
        slam.process(feat, f["pose"], stamp=float(i), raw=(f["gray"], None) if i else None)
    sigs = [slam.memory.get(i) for i in sorted(slam.memory.signatures)]
    assert sigs[0].image is None
    for s in sigs[1:]:
        np.testing.assert_array_equal(s.image, frames[s.id - 1]["gray"])

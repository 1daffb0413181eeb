"""Signature registration: the port's _registration_kernel,
Memory.compute_transform and its batched and asynchronous forms against
the JAX twins on the same signatures, with the JAX twin's own RANSAC
samples injected (``indices=``).

Signatures: four 160x120 renders (fx = fy = 120) along
``loop_trajectory(96)``, 128 GFTT/BRIEF keypoints extracted once by the
JAX package; nodes 1-3 register against node 4 (one to three frames
apart), with and without the guess-projected window.

Tolerances and why: mutual match indices and flags, inlier masks and
counts, success exactly; transforms to 1e-4 (float32 PnP sums in another
order); the linear covariance and the inlier statistics to 1e-3
relative; the angular covariance to 0.2 relative (arccos of a float32
cosine near 1, see tests/test_torch_odometry_f2m.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.memory import memory as JMEM
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory import memory as MEM
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

K, ITERS = 128, 256   # compute_transform's default: one JAX compile serves both
JCAM = JC.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
CAM_TUPLE = (JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width, JCAM.height, JCAM.dist,
             JCAM.local_transform)


@pytest.fixture(scope="module")
def sigs():
    ex = jax.jit(lambda g, d: extract_features(g, d, JCAM, K))
    out = []
    poses = np.asarray(JS.loop_trajectory(96))[:4]
    for i, pose in enumerate(poses):
        fr = ex(*JS.render(jnp.asarray(pose), JCAM))
        out.append({"desc": np.asarray(fr.desc), "uv": np.asarray(fr.uv),
                    "pts3d": np.asarray(fr.pts3d),
                    "valid3d": np.asarray(fr.valid3d & fr.valid), "pose": pose})
    return out


def _indices(key, valid):
    v = jnp.asarray(np.asarray(valid))   # the JAX twin's draws for these matches
    return tuple(torch.from_numpy(np.array(x)) for x in (
        JR._sample_indices(key, v, ITERS // 2, 6),
        JR._sample_indices(jax.random.fold_in(key, 1), v, ITERS - ITERS // 2, 3)))


def _guess(sigs, a, b):
    A, B = sigs[a]["pose"], sigs[b]["pose"]
    rel = np.linalg.inv(np.vstack([A, [0, 0, 0, 1]])) @ np.vstack([B, [0, 0, 0, 1]])
    return rel[:3].astype(np.float32)


def _memories(sigs):
    jm = JMEM.Memory(JParameters({"Tpu/VocabularyCapacity": 1024}), node_capacity=8,
                     words_per_frame=K)
    pm = MEM.Memory(Parameters({"Tpu/VocabularyCapacity": 1024}), node_capacity=8,
                    words_per_frame=K, device="cpu")
    for i, s in enumerate(sigs):
        for mem, Sig in ((jm, JMEM.Signature), (pm, MEM.Signature)):
            mem.signatures[i + 1] = Sig(id=i + 1, map_id=0, stamp=float(i), pose=s["pose"],
                                        desc=s["desc"], uv=s["uv"], pts3d=s["pts3d"],
                                        valid3d=s["valid3d"])
    return jm, pm


def _same_result(p, j):
    t_p, cov_p, inl_p = p
    t_j, cov_j, inl_j = j
    assert inl_p == inl_j and (t_p is None) == (t_j is None)
    if t_j is not None:
        np.testing.assert_allclose(t_p, np.asarray(t_j), atol=1e-4)
        np.testing.assert_allclose(np.diag(cov_p)[:3], np.diag(np.asarray(cov_j))[:3],
                                   rtol=1e-3)
        np.testing.assert_allclose(np.diag(cov_p)[3:], np.diag(np.asarray(cov_j))[3:],
                                   rtol=0.2)


def _same_stats(pm, jm):
    p, j = pm.last_registration, jm.last_registration
    for k in ("matches", "inliers"):
        assert p[k] == j[k], k
    for k in ("mean_dist", "distribution", "lin_variance", "inliers_ratio"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("window", [False, True], ids=["nndr", "window"])
def test_registration_kernel_matches_the_twin(sigs, window):
    a, b = sigs[1], sigs[3]
    guess = _guess(sigs, 1, 3)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    args_p = (t(a["desc"]), t(a["valid3d"]), t(a["pts3d"]), t(a["uv"]), t(b["desc"]),
              t(b["valid3d"]), t(b["uv"]), t(b["pts3d"]), t(guess), CAM)
    key = jax.random.PRNGKey(11)
    _, mm, _ = MEM._registration_kernel(*args_p, torch.Generator(), ITERS, 4.0, 20,
                                        window_px=40.0, use_window=window)
    res_p, mm_p, (md_p, sp_p) = MEM._registration_kernel(
        *args_p, None, ITERS, 4.0, 20, window_px=40.0, use_window=window,
        indices=_indices(key, mm.valid.numpy()))
    res_j, mm_j, (md_j, sp_j) = JMEM._registration_kernel(
        *(jnp.asarray(x) for x in (a["desc"], a["valid3d"], a["pts3d"], a["uv"], b["desc"],
                                   b["valid3d"], b["uv"], b["pts3d"], guess)),
        CAM_TUPLE, key, ITERS, jnp.float32(4.0), 20, window_px=jnp.float32(40.0),
        use_window=window)
    np.testing.assert_array_equal(mm_p.idx.numpy(), np.asarray(mm_j.idx))
    np.testing.assert_array_equal(mm_p.valid.numpy(), np.asarray(mm_j.valid))
    np.testing.assert_array_equal(res_p.inliers.numpy(), np.asarray(res_j.inliers))
    assert bool(res_p.success) == bool(res_j.success) and bool(res_j.success)
    np.testing.assert_allclose(res_p.transform.numpy(), np.asarray(res_j.transform), atol=1e-4)
    np.testing.assert_allclose([float(md_p), float(sp_p)], [float(md_j), float(sp_j)],
                               rtol=1e-3)


def test_compute_transform_and_batch(sigs):
    jm, pm = _memories(sigs)
    key = jax.random.PRNGKey(3)
    # single pair, no guess (identity joins the pool)
    _, mm, _ = MEM._registration_kernel(
        *(torch.from_numpy(np.array(x)) for x in (
            sigs[2]["desc"], sigs[2]["valid3d"], sigs[2]["pts3d"], sigs[2]["uv"],
            sigs[3]["desc"], sigs[3]["valid3d"], sigs[3]["uv"], sigs[3]["pts3d"])),
        torch.eye(3, 4), CAM, torch.Generator(), ITERS, 4.0, 20)
    ref = jm.compute_transform(3, 4, JCAM, key)
    got = pm.compute_transform(3, 4, CAM, indices=_indices(key, mm.valid))
    _same_result(got, ref)
    _same_stats(pm, jm)
    assert got[0] is not None
    # three candidates against node 4 in one batched call, and its
    # enqueue/collect halves
    ids = [1, 2, 3]
    guesses = [_guess(sigs, i - 1, 3) for i in ids]
    keys = jax.random.split(key, len(ids))
    idx = []
    for i, g, k in zip(ids, guesses, keys):
        _, mm, _ = MEM._registration_kernel(
            *(torch.from_numpy(np.array(x)) for x in (
                sigs[i - 1]["desc"], sigs[i - 1]["valid3d"], sigs[i - 1]["pts3d"],
                sigs[i - 1]["uv"], sigs[3]["desc"], sigs[3]["valid3d"], sigs[3]["uv"],
                sigs[3]["pts3d"], g)), CAM, torch.Generator(), ITERS, 4.0, 20)
        idx.append(_indices(k, mm.valid))
    idx = tuple(torch.stack([x[n] for x in idx]) for n in range(2))
    refs = jm.compute_transform_batch(ids, 4, JCAM, key, guesses)
    gots = pm.compute_transform_batch(ids, 4, CAM, None, guesses, indices=idx)
    for p, j in zip(gots, refs):
        _same_result(p, j)
    _same_stats(pm, jm)
    handles = pm.compute_transform_batch_async(ids, 4, CAM, None, guesses, indices=idx)
    for p, j in zip(pm.collect_transform_batch(handles), refs):
        _same_result(p, j)
    assert sum(r[0] is not None for r in gots) >= 2


def test_unported_correspondence_modes_raise(sigs):
    pm = MEM.Memory(Parameters({"Tpu/VocabularyCapacity": 1024, "Vis/CorNNType": 7}),
                    node_capacity=8, words_per_frame=K, device="cpu")
    _, pm2 = _memories(sigs)
    pm.signatures = pm2.signatures
    # Vis/CorNNType 7 (GMS) is ported (tests/test_torch_gms.py): it
    # registers consecutive nodes
    assert pm.compute_transform(1, 2, CAM, torch.Generator())[0] is not None
    # Vis/CorType 1 (optical flow: tests/test_torch_flow_imu.py) and
    # Vis/CorNNType 6 (the matcher: tests/test_torch_superglue.py) are
    # ported; signatures without their images or float descriptors register
    # by descriptors, as the twin's do: the same result as the default
    # mode on the same samples
    _, pm = _memories(sigs)
    _, mm, _ = MEM._registration_kernel(
        *(torch.from_numpy(np.array(x)) for x in (
            sigs[2]["desc"], sigs[2]["valid3d"], sigs[2]["pts3d"], sigs[2]["uv"],
            sigs[3]["desc"], sigs[3]["valid3d"], sigs[3]["uv"], sigs[3]["pts3d"])),
        torch.eye(3, 4), CAM, torch.Generator(), ITERS, 4.0, 20)
    idx = _indices(jax.random.PRNGKey(4), mm.valid)
    for mode in ({"Vis/CorType": 1}, {"Vis/CorNNType": 6}):
        other = MEM.Memory(Parameters({"Tpu/VocabularyCapacity": 1024, **mode}),
                           node_capacity=8, words_per_frame=K, device="cpu")
        other.signatures = pm.signatures
        got = other.compute_transform(3, 4, CAM, indices=idx)
        _same_result(got, pm.compute_transform(3, 4, CAM, indices=idx))
        assert other.matcher_calls == 0
        assert got[0] is not None and other.signatures[3].image is None
        assert other.signatures[3].descf is None

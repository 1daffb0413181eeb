"""Grid Motion Statistics (Vis/CorNNType 7): the port's gms_filter and
the GMS branch of the signature registration against the JAX twins.

gms_filter runs on the twin test's cases (tests/test_gms.py: 150 matches
under one coherent motion and 40 random ones at 320x240, and an all-
invalid set) and on both batched. The registration: four 160x120 renders
along ``loop_trajectory(96)``, 128 GFTT/BRIEF keypoints extracted once by
the JAX package, node 2 -> node 4 through ``Memory.compute_transform``
with ``Vis/CorNNType`` 7, the JAX twin's RANSAC samples injected.

Tolerances and why: the surviving masks exactly (the cell-pair counts and
their 3x3 box sums are whole numbers, exact in float32 in any order);
the registration as tests/test_torch_registration.py holds it (inlier
counts exact, transforms 1e-4, covariances 1e-3 / 0.2 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.memory import memory as JMEM
from rtabmap_tpu.ops import matching as JM
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory import memory as MEM
from rtabmap_tpu_torch.ops import matching as TM
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

H, W = 240, 320


def _cases():
    """tests/test_gms.py's coherent + random matches (seed 0)."""
    rng = np.random.default_rng(0)
    n_good, n_bad = 150, 40
    a_good = rng.uniform([10, 10], [W - 10, H - 10], (n_good, 2)).astype(np.float32)
    b_good = a_good + np.array([8.0, -3.0], np.float32)
    a_bad = rng.uniform([10, 10], [W - 10, H - 10], (n_bad, 2)).astype(np.float32)
    b_bad = rng.uniform([10, 10], [W - 10, H - 10], (n_bad, 2)).astype(np.float32)
    return np.concatenate([a_good, a_bad]), np.concatenate([b_good, b_bad]), n_good


def test_gms_coherent_and_random_masks_exact():
    uv_a, uv_b, n_good = _cases()
    valid = np.ones(len(uv_a), bool)
    valid[::17] = False                       # a few invalid matches too
    for v in (np.ones(len(uv_a), bool), valid):
        kj = np.asarray(JM.gms_filter(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(v),
                                      (H, W), (H, W)))
        kt = TM.gms_filter(torch.from_numpy(uv_a), torch.from_numpy(uv_b),
                           torch.from_numpy(v), (H, W), (H, W)).numpy()
        np.testing.assert_array_equal(kt, kj)
        assert kt[:n_good].mean() > 0.7 and kt[n_good:].mean() < 0.25
    # batched over a leading axis: each row as alone
    uv_a2 = np.stack([uv_a, uv_b])
    uv_b2 = np.stack([uv_b, uv_a[::-1].copy()])
    v2 = np.stack([valid, np.ones(len(uv_a), bool)])
    kt2 = TM.gms_filter(torch.from_numpy(uv_a2), torch.from_numpy(uv_b2), torch.from_numpy(v2),
                        (H, W), (H, W)).numpy()
    for i in range(2):
        kj = np.asarray(JM.gms_filter(jnp.asarray(uv_a2[i]), jnp.asarray(uv_b2[i]),
                                      jnp.asarray(v2[i]), (H, W), (H, W)))
        np.testing.assert_array_equal(kt2[i], kj)


def test_gms_respects_valid_mask():
    uv = np.zeros((10, 2), np.float32)
    keep = TM.gms_filter(torch.from_numpy(uv), torch.from_numpy(uv), torch.zeros(10, dtype=torch.bool),
                         (100, 100), (100, 100))
    assert not keep.any()
    # all in one cell pair: support 10 >= 6 sqrt(10/9)
    keep = TM.gms_filter(torch.from_numpy(uv), torch.from_numpy(uv), torch.ones(10, dtype=torch.bool),
                         (100, 100), (100, 100))
    assert keep.all()


K, ITERS = 128, 256
JCAM = JC.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)


@pytest.fixture(scope="module")
def sigs():
    ex = jax.jit(lambda g, d: extract_features(g, d, JCAM, K))
    out = []
    for pose in np.asarray(JS.loop_trajectory(96))[:4]:
        fr = ex(*JS.render(jnp.asarray(pose), JCAM))
        out.append({"desc": np.asarray(fr.desc), "uv": np.asarray(fr.uv),
                    "pts3d": np.asarray(fr.pts3d),
                    "valid3d": np.asarray(fr.valid3d & fr.valid), "pose": pose})
    return out


def test_memory_registration_with_gms_matches_the_twin(sigs):
    jm = JMEM.Memory(JParameters({"Tpu/VocabularyCapacity": 1024, "Vis/CorNNType": 7}),
                     node_capacity=8, words_per_frame=K)
    pm = MEM.Memory(Parameters({"Tpu/VocabularyCapacity": 1024, "Vis/CorNNType": 7}),
                    node_capacity=8, words_per_frame=K, device="cpu")
    for i, s in enumerate(sigs):
        for mem, Sig in ((jm, JMEM.Signature), (pm, MEM.Signature)):
            mem.signatures[i + 1] = Sig(id=i + 1, map_id=0, stamp=float(i), pose=s["pose"],
                                        desc=s["desc"], uv=s["uv"], pts3d=s["pts3d"],
                                        valid3d=s["valid3d"])
    a, b = sigs[1], sigs[3]
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    args = (t(a["desc"]), t(a["valid3d"]), t(a["pts3d"]), t(a["uv"]), t(b["desc"]),
            t(b["valid3d"]), t(b["uv"]), t(b["pts3d"]), torch.eye(3, 4), CAM,
            torch.Generator(), ITERS, 4.0, 20)
    _, plain, _ = MEM._registration_kernel(*args)
    _, mm, _ = MEM._registration_kernel(*args, use_gms=True)
    n_mutual = int(plain.valid.sum())
    assert n_mutual >= 30 and int(mm.valid.sum()) < n_mutual   # GMS ran and removed some
    assert not (mm.valid & ~plain.valid).any()
    key = jax.random.PRNGKey(5)
    v = jnp.asarray(mm.valid.numpy())
    idx = tuple(torch.from_numpy(np.array(x)) for x in (
        JR._sample_indices(key, v, ITERS // 2, 6),
        JR._sample_indices(jax.random.fold_in(key, 1), v, ITERS - ITERS // 2, 3)))
    t_j, cov_j, inl_j = jm.compute_transform(2, 4, JCAM, key)
    t_p, cov_p, inl_p = pm.compute_transform(2, 4, CAM, indices=idx)
    assert inl_p == inl_j and t_j is not None and t_p is not None
    assert pm.last_registration["matches"] == jm.last_registration["matches"] == int(v.sum())
    np.testing.assert_allclose(t_p, np.asarray(t_j), atol=1e-4)
    np.testing.assert_allclose(np.diag(cov_p)[:3], np.diag(np.asarray(cov_j))[:3], rtol=1e-3)
    np.testing.assert_allclose(np.diag(cov_p)[3:], np.diag(np.asarray(cov_j))[3:], rtol=0.2)

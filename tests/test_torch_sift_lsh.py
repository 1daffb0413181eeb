"""SIFT descriptors, their sign-LSH words and the l2 metric: the port on
the CPU against the JAX package on one rendered 160x120 frame.

Tolerances, with their reasons:
- extract_patches: exact (both select bfloat16-rounded image values);
- describe_sift: 1e-5 absolute on unit-norm descriptors (the pooling
  products and the norms sum in another order; a gradient angle at an
  orientation-bin boundary moves its weight continuously);
- the shipped LSH hyperplanes: bit for bit equal to
  ``jax.random.normal(PRNGKey(0), (128, 256))`` drawn here (the draw
  depends on JAX's PRNG settings, so this is what notices a drift);
- LSH words: a bit may differ only where |x.R| < 1e-5 (the two products
  round differently near 0); the flips are counted and reported;
- l2_matrix: 1e-5 relative to the largest distance (float32 products in
  another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core import frame as JFr
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.ops import features as JF
from rtabmap_tpu.ops import image as JI
from rtabmap_tpu.ops import matching as JM
from rtabmap_tpu_torch.core import frame as TFr
from rtabmap_tpu_torch.geometry import camera as TC
from rtabmap_tpu_torch.ops import features as TF
from rtabmap_tpu_torch.ops import matching as TM
from torch_port_threads import one_torch_thread  # noqa: F401

W, H, MAX_KP = 160, 120, 64
LSH_EPS = 1e-5


@pytest.fixture(scope="module")
def frame():
    jc = JC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    tc = TC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    g, d = JS.render(jnp.asarray(np.asarray(JS.loop_trajectory(12))[2]), jc)
    g = np.asarray(g)
    kj = JF.compute_orientation(jnp.asarray(g), JF.select_top_k_grid(
        JF.dog_response(jnp.asarray(g)), MAX_KP, (4, 4), 7, 0.01))
    blur = np.array(JI.gaussian_blur(jnp.asarray(g), sigma=2.0, radius=4))
    return jc, tc, g, np.asarray(d), kj, blur


def _port_kps(kj):
    return TF.Keypoints(*(torch.from_numpy(np.array(x)) for x in kj))


def test_extract_patches_match(frame):
    *_, kj, blur = frame
    # the keypoints plus positions at the image border (clamped patches)
    uv = np.concatenate([np.asarray(kj.uv), [[0.0, 0.0], [W - 1.0, H - 1.0], [3.4, 100.6]]])
    pj = np.asarray(JF.extract_patches(jnp.asarray(blur), jnp.asarray(uv, jnp.float32)))
    pt = TF.extract_patches(torch.from_numpy(blur), torch.from_numpy(uv.astype(np.float32)))
    np.testing.assert_array_equal(pt.numpy(), pj)


def test_describe_sift_matches(frame):
    *_, kj, blur = frame
    dj = np.asarray(JF.describe_sift(jnp.asarray(blur), kj))
    dt = TF.describe_sift(torch.from_numpy(blur), _port_kps(kj)).numpy()
    assert dt.shape == (MAX_KP, TF.SIFT_DIM) and dt.dtype == np.float32
    valid = np.asarray(kj.valid)
    assert valid.sum() >= 16
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(dt[valid], axis=1), 1.0, atol=1e-5)
    assert np.all(dt[~valid] == 0)
    np.testing.assert_array_equal(TF._SIFT_SPATIAL, JF._SIFT_SPATIAL)


def test_shipped_lsh_matrix_equals_the_jax_draw():
    r = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (JF.SIFT_DIM, JF.DESC_DIM)))
    shipped = TFr.lsh_planes("cpu").numpy()
    assert shipped.dtype == np.float32 and shipped.shape == (128, 256)
    np.testing.assert_array_equal(shipped, r)


@pytest.mark.parametrize("strategy", [1, 2])
def test_extract_features_strategy(frame, strategy):
    """Strategy 1 (DoG + SIFT -> sign-LSH words) and 2 (ORB: FAST + BRIEF)
    through extract_features and the FeatureExtractor."""
    from rtabmap_tpu_torch.utils.params import Parameters

    jc, tc, g, d, *_ = frame
    det, desc = TFr.CLASSICAL_STRATEGIES[strategy]
    fj = JFr.extract_features(jnp.asarray(g), jnp.asarray(d), jc, MAX_KP, detector=det,
                              descriptor=desc)
    fe = TFr.FeatureExtractor(tc, Parameters({"Kp/DetectorStrategy": strategy}),
                              max_kp=MAX_KP, device="cpu")
    ft, descf = fe.extract(g, d)
    assert descf is None and ft.desc.dtype == torch.int8
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_allclose(ft.uv.numpy(), np.asarray(fj.uv), atol=1e-3)
    np.testing.assert_allclose(ft.pts3d.numpy(), np.asarray(fj.pts3d), atol=1e-5)
    bt, bj = ft.desc.numpy(), np.asarray(fj.desc)
    flips = bt != bj
    if desc == "sift":
        kps, sift = TF.detect_and_describe(torch.from_numpy(g.copy()), MAX_KP, detector=det,
                                           descriptor="sift")
        x = sift / torch.clamp(torch.linalg.norm(sift, dim=-1, keepdim=True), min=1e-8)
        proj = (x @ TFr.lsh_planes("cpu")).numpy()
        assert np.all(np.abs(proj[flips]) < LSH_EPS), np.abs(proj[flips]).max()
        print(f"LSH bits flipped: {int(flips.sum())} of {int(ft.valid.sum()) * 256}")
    else:
        assert not flips.any()


def test_l2_matrix_and_distance_matrix():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 37, 128)).astype(np.float32)
    b = rng.standard_normal((2, 53, 128)).astype(np.float32)
    lj = np.stack([np.asarray(JM.l2_matrix(jnp.asarray(a[i]), jnp.asarray(b[i])))
                   for i in range(2)])
    lt = TM.l2_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()   # batched
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5 * lj.max())
    np.testing.assert_array_equal(
        TM.distance_matrix(torch.from_numpy(a[0]), torch.from_numpy(b[0]), "l2").numpy(), lt[0])
    # NNDR matching on the l2 metric: the same matches as the twin
    mj = JM.match_nndr(jnp.asarray(a[0]), jnp.ones(37, bool), jnp.asarray(a[0, ::-1] + 0.1),
                       jnp.ones(37, bool), metric="l2")
    mt = TM.match_nndr(torch.from_numpy(a[0]), torch.ones(37, dtype=torch.bool),
                       torch.from_numpy(a[0, ::-1] + 0.1), torch.ones(37, dtype=torch.bool),
                       metric="l2")
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert mt.valid.all()

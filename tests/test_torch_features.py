"""GFTT/BRIEF features and the renderer: the port on the CPU against the
JAX package on one rendered 160x120 frame (max_kp=64).

Tolerances, with their reasons:
- render: exact (the same float32 elementwise ops and integer hash);
- response map: rtol 1e-5 / atol 1e-6 — the banded blur products sum the
  same terms in another order;
- keypoints: the same valid set at the same integer peaks; the subpixel
  offset (-dx/dxx of response differences) within 1e-3 px;
- descriptors: bit-exact on the matching keypoints (bfloat16 patch values
  and the same tests);
- pts3d: 1e-5 (bilinear depth lookup at the subpixel position).
No near-tie was seen on this frame; any would be listed here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core import frame as JFr
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.ops import features as JF
from rtabmap_tpu_torch.core import frame as TFr
from rtabmap_tpu_torch.datasets import synthetic as TS
from rtabmap_tpu_torch.geometry import camera as TC
from rtabmap_tpu_torch.ops import features as TF
from torch_port_threads import one_torch_thread  # noqa: F401

W, H, MAX_KP = 160, 120, 64


@pytest.fixture(scope="module")
def frame():
    jc = JC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    tc = TC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    pose = np.asarray(JS.loop_trajectory(12))[3]
    g, d = JS.render(jnp.asarray(pose), jc)
    return jc, tc, pose, np.asarray(g), np.asarray(d)


def test_render_and_trajectory_match(frame):
    jc, tc, pose, g, d = frame
    np.testing.assert_array_equal(TS.loop_trajectory(12)[3], pose)
    tg, td = TS.render(pose, tc, device="cpu")
    np.testing.assert_array_equal(tg.numpy(), g)
    np.testing.assert_array_equal(td.numpy(), d)


def test_brief_tests_match_difference_matrices():
    mats = JF._TEST_MATS                               # (30, 1024, 256)
    idx = TF._binned_test_indices()                    # (30, 256, 2)
    b, t = np.meshgrid(np.arange(mats.shape[0]), np.arange(mats.shape[2]), indexing="ij")
    rebuilt = np.zeros_like(mats)
    np.add.at(rebuilt, (b, idx[..., 0], t), 1.0)
    np.add.at(rebuilt, (b, idx[..., 1], t), -1.0)
    np.testing.assert_array_equal(rebuilt, mats)


def test_detect_and_describe_matches(frame):
    _, _, _, g, _ = frame
    rj = np.asarray(JF.shi_tomasi_response(jnp.asarray(g)))
    rt = TF.shi_tomasi_response(torch.from_numpy(g.copy())).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-6)

    kj, dj = JF.detect_and_describe(jnp.asarray(g), MAX_KP)
    kt, dt = TF.detect_and_describe(torch.from_numpy(g.copy()), MAX_KP)
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() >= 32
    uvj, uvt = np.asarray(kj.uv)[vj], kt.uv.numpy()[vt]
    np.testing.assert_array_equal(np.round(uvt), np.round(uvj))
    np.testing.assert_allclose(uvt, uvj, atol=1e-3)
    np.testing.assert_allclose(kt.angle.numpy()[vt], np.asarray(kj.angle)[vj], atol=1e-4)
    np.testing.assert_array_equal(dt.numpy()[vt], np.asarray(dj)[vj])
    assert np.all(dt.numpy()[~vt] == 0)


def test_extract_features_and_extractor_match(frame):
    jc, tc, _, g, d = frame
    fj = JFr.extract_features(jnp.asarray(g), jnp.asarray(d), jc, MAX_KP)
    ft = TFr.extract_features(torch.from_numpy(g.copy()), torch.from_numpy(d.copy()), tc,
                              MAX_KP)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.valid3d.numpy(), np.asarray(fj.valid3d))
    np.testing.assert_array_equal(ft.desc.numpy(), np.asarray(fj.desc))
    np.testing.assert_allclose(ft.pts3d.numpy(), np.asarray(fj.pts3d), atol=1e-5)

    fe = TFr.FeatureExtractor(tc, max_kp=MAX_KP, device="cpu")
    fx, descf = fe.extract(g, d)
    assert descf is None
    np.testing.assert_array_equal(fx.desc.numpy(), ft.desc.numpy())
    np.testing.assert_array_equal(fx.uv.numpy(), ft.uv.numpy())

"""SuperPoint: the port's ``models/superpoint.py`` and ``FeatureExtractor``'s
learned strategies against the JAX twin on the same parameters (the
bundled distilled weights, and seeded random ones from the twin's
``init_params``) and the same 64x96 render.

Tolerances and why: the float32 network within 1e-4 of the largest
output magnitude (the CPU sums the convolutions' products in another
order), and its keypoints and binary descriptors exactly equal (scores
within 1e-6, descf within 1e-5); the
bfloat16 network within 1e-2 of the largest magnitude (a float32 sum that
lies near a bfloat16 rounding boundary rounds the other way, one unit,
2^-8 relative, and the difference spreads through the later layers), and
the post-processing (score map, NMS, top-k, threshold, descriptor
sampling and binarization) exactly equal given the twin's logits and
descriptor map (descf within 1e-6: a float32 norm)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FeatureExtractor as JFeatureExtractor
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.models import superpoint as JSP
from rtabmap_tpu.ops import features as JF
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.core.frame import FeatureExtractor
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.models import superpoint as SP
from rtabmap_tpu_torch.ops import features as F
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

H, W = 64, 96
CAM = (80.0, 80.0, 47.5, 31.5, W, H)


def _flat(params) -> dict:
    return {"/".join(p.key for p in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def frame():
    g, d = JS.render(JS.loop_trajectory(36)[3], JC.CameraModel.make(*CAM))
    return np.asarray(g), np.asarray(d)


@pytest.fixture(scope="module", params=["distilled", "random"])
def params(request):
    if request.param == "distilled":
        return JSP.SuperPoint.distilled().params
    return JSP.SuperPoint(seed=3).init_params(jax.random.PRNGKey(3), H, W)


def _twin_post(logits, desc_map, max_kp, nms, thr):
    """The twin's _extract after its network, step by step."""
    score = JSP.score_map_from_logits(logits)[0]
    kps = JF.select_top_k(score, max_kp, nms_size=nms, quality_level=0.0, border=JSP.CELL)
    kps = kps._replace(valid=kps.valid & (kps.response > thr))
    descf = JSP._sample_descriptors(desc_map[0], kps.uv)
    desc = jnp.where(descf >= 0, 1, -1).astype(jnp.int8)
    return kps, jnp.where(kps.valid[:, None], desc, 0).astype(jnp.int8), descf


def _same_extraction(port, twin, descf_tol=1e-6, response_tol=1e-7):
    (kp, dp, fp), (kj, dj, fj) = port, twin
    np.testing.assert_array_equal(kp.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(kp.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_allclose(kp.response.numpy(), np.asarray(kj.response), atol=response_tol)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=descf_tol)


def test_float32_network_and_extraction_match_the_twin(frame, params):
    g = frame[0]
    jl, jd = JSP.SuperPointNet(dtype=jnp.float32).apply({"params": params},
                                                        jnp.asarray(g)[None, :, :, None])
    sp = SP.SuperPoint(params=SP.params_from_flax(_flat(params)), device="cpu",
                       dtype=torch.float32)
    tl, td = sp.forward(g)
    for t, j in ((tl, jl), (td, jd)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
    port = SP.postprocess(tl, td, 48, 9, 0.005)
    twin = _twin_post(jl, jd, 48, 9, 0.005)
    assert int(port[0].valid.sum()) > 5
    _same_extraction(port, twin, descf_tol=1e-5, response_tol=1e-6)


def test_bfloat16_network_within_rounding_and_postprocessing_exact(frame):
    g = frame[0]
    js = JSP.SuperPoint.distilled()
    jl, jd = jax.jit(lambda p, x: JSP.SuperPointNet().apply({"params": p}, x))(
        js.params, jnp.asarray(g)[None, :, :, None])
    sp = SP.SuperPoint.distilled(device="cpu")
    tl, td = sp.forward(g)
    for t, j in ((tl, jl), (td, jd)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-2 * np.abs(j).max()
    twin = js.extract(jnp.asarray(g), 48, conf_threshold=0.01)
    port = SP.postprocess(torch.from_numpy(np.asarray(jl)), torch.from_numpy(np.asarray(jd)),
                          48, 9, 0.01)
    assert int(port[0].valid.sum()) > 5
    _same_extraction(port, twin)


def test_score_map_and_descriptor_sampling_match_the_twin():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(1, 3, 5, 65)).astype(np.float32) * 3
    np.testing.assert_allclose(SP.score_map_from_logits(torch.from_numpy(logits)).numpy(),
                               np.asarray(JSP.score_map_from_logits(jnp.asarray(logits))),
                               atol=1e-7)
    # a lone spike in channel cy*8 + cx of cell (hc, wc) lands at (hc*8 + cy, wc*8 + cx)
    spike = np.full((1, 3, 5, 65), -20.0, np.float32)
    spike[0, 2, 4, 3 * 8 + 6] = 20.0
    score = SP.score_map_from_logits(torch.from_numpy(spike))[0]
    assert tuple(np.unravel_index(int(score.argmax()), score.shape)) == (2 * 8 + 3, 4 * 8 + 6)
    desc_map = rng.normal(size=(3, 5, 16)).astype(np.float32)
    uv = np.array([[0, 0], [39.5, 23.5], [13.2, 7.9], [100.0, -4.0]], np.float32)
    np.testing.assert_allclose(
        SP._sample_descriptors(torch.from_numpy(desc_map), torch.from_numpy(uv)).numpy(),
        np.asarray(JSP._sample_descriptors(jnp.asarray(desc_map), jnp.asarray(uv))), atol=1e-6)


def test_weights_load_across_packages(tmp_path, frame):
    g = frame[0]
    # the port's save_params is read by the twin, and the twin's by the port
    sp = SP.SuperPoint(seed=5, device="cpu", dtype=torch.float32)
    path = str(tmp_path / "port.npz")
    sp.save_params(path)
    js = JSP.SuperPoint.load_params(path)
    jl, _ = JSP.SuperPointNet(dtype=jnp.float32).apply({"params": js.params},
                                                       jnp.asarray(g)[None, :, :, None])
    tl, _ = sp.forward(g)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4 * float(tl.abs().max()))
    path2 = str(tmp_path / "twin.npz")
    JSP.SuperPoint(seed=2).save_params(path2)
    back = SP.SuperPoint.load_params(path2, device="cpu")
    for k, v in SP.params_from_flax(dict(np.load(path2))).items():
        assert torch.equal(back.params[k], v), k
    # SuperPoint/ModelPath selects them; a missing file raises
    fe = FeatureExtractor(C.CameraModel.make(*CAM), Parameters(
        {"Kp/DetectorStrategy": 11, "SuperPoint/ModelPath": path2}), device="cpu")
    assert torch.equal(fe._sp.params["convs.0.weight"], back.params["convs.0.weight"])
    with pytest.raises(FileNotFoundError):
        FeatureExtractor(C.CameraModel.make(*CAM), Parameters(
            {"Kp/DetectorStrategy": 11, "SuperPoint/ModelPath": str(tmp_path / "no.npz")}),
            device="cpu")

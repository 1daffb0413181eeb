"""The two SuperGlue matchers and the Vis/CorNNType 6 registration: the
port's ``models/superglue.py`` (the bundled distilled matcher),
``models/superglue_official.py`` (the official architecture) and
``Memory.compute_transform``'s matcher route against the JAX twins on the
same parameters and inputs (K = 32), and the CLI's matcher tool on two
160x120 PNGs. The registration through the matcher
(``Memory.compute_transform``) is held to its twin in
tests/test_torch_engine_learned.py, beside the engine's (one JAX compile
serves both).

Tolerances and why: scores and log transports within 1e-4 (float32
matrix products and logsumexp summed in another order); idx and valid
exactly equal away from the threshold (a confidence within 1e-4 of it may
flip, none does here); the matcher tool's counts exactly, given the
twin's epipolar samples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.models import convert as JCV
from rtabmap_tpu.models import superglue as JSG
from rtabmap_tpu.models import superglue_official as JSGO
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.models import convert as CV
from rtabmap_tpu_torch.models import superglue as SG
from rtabmap_tpu_torch.models import superglue_official as SGO
from torch_port_threads import one_torch_thread  # noqa: F401

K, TOL = 32, 1e-4
CAM = (120.0, 120.0, 79.5, 59.5, 160, 120)


def _inputs(seed, n=K, drop=0.2):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    uv = (rng.random((n, 2)) * [320, 240]).astype(np.float32)
    return [d, uv, np.full(n, 0.5, np.float32), rng.random(n) >= drop]


def _pair(seed):
    """Image b: a's keypoints moved a pixel with noisy descriptors, others
    invalid."""
    a, b = _inputs(seed), _inputs(seed + 100)
    rng = np.random.default_rng(seed + 7)
    b[0] = (a[0] + 0.15 * rng.normal(size=a[0].shape)).astype(np.float32)
    b[1] = a[1] + 1.0
    return a, b


def _matcher_pair(kind):
    if kind == "distilled":
        return JSG.SuperGlueMatcher.distilled(), SG.SuperGlueMatcher.distilled(device="cpu")
    jm = JSG.SuperGlueMatcher(seed=4)
    jm.params = jm.init_params(jax.random.PRNGKey(4), k=K)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(jm.params).items()}
    return jm, SG.SuperGlueMatcher(params=SG.params_from_flax(flat), device="cpu")


def _same_matches(p, j, threshold):
    ip, vp, cp = (x.numpy() for x in p)
    ij, vj, cj = (np.asarray(x) for x in j)
    np.testing.assert_allclose(cp, cj, atol=TOL)
    far = np.abs(cj - threshold) > TOL
    np.testing.assert_array_equal(vp[far], vj[far])
    np.testing.assert_array_equal(ip[far & vj], ij[far & vj])
    return int(vj.sum())


@pytest.mark.parametrize("kind", ["distilled", "random"])
def test_distilled_matcher_matches_the_twin(kind):
    jm, tm = _matcher_pair(kind)
    a, b = _pair(0)
    n = _same_matches(tm.match(*a, *b, image_wh=(320.0, 240.0)),
                      jm.match(*(jnp.asarray(x) for x in a + b), image_wh=(320.0, 240.0)), 0.2)
    if kind == "distilled":
        assert n >= 10
    assert tm.calls == 1
    # the log transport itself
    s = np.float32([160.0, 120.0])
    na, nb = a[1] / s - 1, b[1] / s - 1
    js, jdust = jm.net.apply(jm.params, jnp.asarray(a[0]), jnp.asarray(na), jnp.asarray(a[2]),
                             jnp.asarray(a[3]), jnp.asarray(b[0]), jnp.asarray(nb),
                             jnp.asarray(b[2]), jnp.asarray(b[3]))
    jl = np.asarray(JSG.log_sinkhorn(js, jdust, jnp.asarray(a[3]), jnp.asarray(b[3])))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    with torch.no_grad():
        ts, tdust = tm.net(t(a[0]), t(na), t(a[2]), t(a[3]), t(b[0]), t(nb), t(b[2]), t(b[3]))
        tl = SG.log_sinkhorn(ts, tdust, t(a[3]), t(b[3])).numpy()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    live = jl > -1e8     # the masked entries sit near -1e9
    np.testing.assert_array_equal(tl > -1e8, live)
    np.testing.assert_allclose(tl[live], jl[live], atol=TOL)


def test_fully_masked_rows_stay_finite():
    """A keypoint whose keys are all masked gets flax's uniform attention
    weights (the float32 minimum, not -inf), and both engines agree."""
    jm, tm = _matcher_pair("distilled")
    a, b = _pair(1)
    b[3] = np.zeros(K, bool)
    p = tm.match(*a, *b)
    j = jm.match(*(jnp.asarray(x) for x in a + b))
    assert torch.isfinite(p[2]).all() and not p[1].any()
    _same_matches(p, j, 0.2)


def _state_dict(layout: str, n_layers: int, seed: int = 0) -> dict:
    """Seeded random official SuperGlue weights in the MagicLeap or the
    HF-transformers checkpoint layout (BatchNorm statistics randomized)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def lin(name, o, i, conv):
        b = 1.0 / np.sqrt(i)
        sd[f"{name}.weight"] = rng.uniform(-b, b, (o, i, 1) if conv else (o, i)).astype(
            np.float32)
        sd[f"{name}.bias"] = rng.uniform(-b, b, o).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    dims = (3, 32, 64, 128, 256)
    ml = layout == "magicleap"
    for j in range(4):
        if ml:
            lin(f"kenc.encoder.{3 * j}", dims[j + 1], dims[j], True)
            bn(f"kenc.encoder.{3 * j + 1}", dims[j + 1])
        else:
            lin(f"keypoint_encoder.encoder.{j}.linear", dims[j + 1], dims[j], False)
            bn(f"keypoint_encoder.encoder.{j}.batch_norm", dims[j + 1])
    lin("kenc.encoder.12" if ml else "keypoint_encoder.encoder.4", 256, 256, ml)
    for i in range(n_layers):
        g = f"gnn.layers.{i}"
        names = (("attn.proj.0", "attn.proj.1", "attn.proj.2", "attn.merge") if ml else
                 ("attention.self.query", "attention.self.key", "attention.self.value",
                  "attention.output.dense"))
        for name in names:
            lin(f"{g}.{name}", 256, 256, ml)
        lin(f"{g}.{'mlp.0' if ml else 'mlp.0.linear'}", 512, 512, ml)
        bn(f"{g}.{'mlp.1' if ml else 'mlp.0.batch_norm'}", 512)
        lin(f"{g}.{'mlp.3' if ml else 'mlp.1'}", 256, 512, ml)
    lin("final_proj" if ml else "final_projection.final_proj", 256, 256, ml)
    sd["bin_score"] = np.float32(1.2)
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("layout", ["magicleap", "hf"])
def test_official_superglue_matches_the_twin(layout, tmp_path):
    sd = _state_dict(layout, n_layers=4)
    pj = JCV.convert_superglue({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    pt = CV.convert_superglue({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    lj, lt = dict(_leaves(pj)), dict(_leaves(pt))
    assert set(lj) == set(lt)
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    a, b = _inputs(5), _inputs(6)
    sc_a, sc_b = np.random.default_rng(8).random((2, K)).astype(np.float32)
    zj = np.asarray(JSGO.superglue_apply(pj, jnp.asarray(a[1]), jnp.asarray(sc_a),
                                         jnp.asarray(a[0]), jnp.asarray(b[1]),
                                         jnp.asarray(sc_b), jnp.asarray(b[0]), 320.0, 240.0,
                                         iters=50))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    params = SGO.to_device(pt, "cpu")
    zt = SGO.superglue_apply(params, t(a[1]), t(sc_a), t(a[0]), t(b[1]), t(sc_b), t(b[0]),
                             320.0, 240.0, iters=50)
    np.testing.assert_allclose(zt.numpy(), zj, atol=TOL)
    _same_matches(SGO.match_from_scores(zt), JSGO.match_from_scores(jnp.asarray(zj)), 0.2)
    # the npz layout round-trips across the packages
    path = str(tmp_path / "sg.npz")
    SGO.save_params(params, path)
    back = dict(_leaves(JSGO.load_params(path)))
    for k in lj:
        np.testing.assert_array_equal(back[k], lj[k], err_msg=k)
    path2 = str(tmp_path / "sg_twin.npz")
    JSGO.save_params(pj, path2)
    back = dict(_leaves(SGO.load_params(path2, "cpu")))
    for k in lj:
        np.testing.assert_array_equal(back[k], lj[k], err_msg=k)


def test_matcher_tool_matches_the_twin(tmp_path, monkeypatch):
    """The CLI's matcher with SuperPoint and the attentional matcher on two
    160x120 PNGs in both packages (the port reads them with its own
    decoder), the port given the twin's epipolar RANSAC samples (its
    PRNGKey(0)). Its NNDR branch is match_mutual_nndr's
    (tests/test_torch_matching.py)."""
    from rtabmap_tpu.tools import cli as JCLI
    from rtabmap_tpu_torch.datasets.png import write_png
    from rtabmap_tpu_torch.ops import epipolar as EP
    from rtabmap_tpu_torch.tools import cli as CLI

    jcam = JC.CameraModel.make(*CAM)
    paths = []
    for w in (0, 1):
        g, _ = JS.render(JS.loop_trajectory(48)[w], jcam)
        paths.append(str(tmp_path / f"{w}.png"))
        write_png(paths[-1], np.round(np.asarray(g) * 255).astype(np.uint8))
    check = EP.check_hypothesis

    def twin_draws(uv_a, uv_b, valid, generator=None, **kw):
        idx = JR._sample_indices(jax.random.PRNGKey(0), jnp.asarray(valid.numpy()), 128, 8)
        return check(uv_a, uv_b, valid, generator, indices=torch.from_numpy(np.array(idx)),
                     **kw)

    monkeypatch.setattr(EP, "check_hypothesis", twin_draws)
    extra = ["--Kp/DetectorStrategy", "11", "--Vis/CorNNType", "6"]
    twin = JCLI.tool_matcher(paths + extra)
    port = CLI.main(["matcher", *paths, *extra, "--device", "cpu"])
    assert port == twin and twin["matches"] >= 20

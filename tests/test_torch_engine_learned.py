"""The learned front end through the engine: ``Rtabmap.process(descf=...)``
with ``Kp/DetectorStrategy`` 11 and ``Vis/CorNNType`` 6, the port against
the JAX engine.

Quick tier: 160x120 renders (fx = fy = 120) of ``loop_trajectory(48)``,
positions 0..8 and then 2, 1, 0 again (12 ticks), 128 SuperPoint keypoints
and their float descriptors extracted once by the JAX package and fed to
both engines as the same numpy arrays, ground-truth odometry,
``Mem/STMSize`` 2, ``VhEp/Enabled`` on, proximity by space off (each
registration is then one loop closure's), the JAX twin's RANSAC samples
injected into the port (PnP and the epipolar check). The revisit closes
two loops, each through the learned epipolar check (the matcher's pairs)
and a SuperGlue registration. ``Memory.compute_transform``'s matcher route,
alone and batched, and the matcher's weight resolution on those features:
the registration succeeds on the revisit of a pose and fails, in both
packages, 7.5 degrees away (its PnP-RANSAC draws 6-point DLT hypotheses
only, degenerate on the room's planar walls: one inlier;
scripts/learned_registration_study.py).

Tolerances and why: loop ids, hypothesis ids, epipolar pair and inlier
counts, visual inliers, link sets (endpoints and types) and statistic
keys exactly; loop-closure and registration transforms within 1e-4
(float32 PnP, as in tests/test_torch_registration.py). The slow tier is the port's twin of
tests/test_learned_stack.py::test_engine_runs_learned_detector_and_matcher,
held to its bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FeatureExtractor as JFeatureExtractor
from rtabmap_tpu.core.frame import FrameFeatures as JFrame
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.memory import memory as JMEM
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory import memory as MEM
from rtabmap_tpu_torch.memory.memory import LINK_GLOBAL_CLOSURE
from rtabmap_tpu_torch.models import convert as CV
from rtabmap_tpu_torch.models import superglue_official as SGO
from rtabmap_tpu_torch.ops import epipolar as EP
from rtabmap_tpu_torch.ops import ransac as R
from rtabmap_tpu_torch.utils.params import Parameters
from test_torch_superglue import _state_dict
from torch_port_threads import one_torch_thread  # noqa: F401

K, ITERS = 128, 256
CAM = (120.0, 120.0, 80.0, 60.0, 160, 120)
WAY = list(range(9)) + [2, 1, 0]
OVER = {"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6, "VhEp/Enabled": True,
        "Mem/STMSize": 2, "RGBD/ProximityBySpace": False, "Tpu/VocabularyCapacity": 8192}


@pytest.fixture(scope="module")
def ticks():
    jcam = JC.CameraModel.make(*CAM)
    fe = JFeatureExtractor(jcam, JParams(OVER), max_kp=K)
    poses = np.asarray(JS.loop_trajectory(48))
    feats = {}
    for w in sorted(set(WAY)):
        fr, descf = fe.extract(*JS.render(jnp.asarray(poses[w]), jcam))
        feats[w] = (tuple(np.asarray(x) for x in fr), np.asarray(descf))
    return [(feats[w], poses[w]) for w in WAY]


def _links(slam):
    return sorted((i, j, lk.type) for i, s in slam.memory.signatures.items()
                  for j, lk in s.links.items())


def test_learned_ticks_match_the_jax_engine(ticks, monkeypatch):
    key = jax.random.PRNGKey(5)
    js = JRtabmap(JC.CameraModel.make(*CAM), JParams(OVER), node_capacity=32,
                  words_per_frame=K)
    ts = Rtabmap(C.CameraModel.make(*CAM), Parameters(OVER), node_capacity=32,
                 words_per_frame=K, device="cpu")
    monkeypatch.setattr(js, "_split_key", lambda: key)
    pnp, check = R.ransac_pnp, EP.check_hypothesis
    drawn = {"pnp": 0, "ep": 0}

    def twin_pnp(pts3d, uv, valid, cam, generator=None, iters=256, indices=None, **kw):
        assert indices is None and kw.get("pts3d_query") is None
        drawn["pnp"] += 1
        idx = JR._sample_indices(key, jnp.asarray(valid.numpy()), iters, 6)
        return pnp(pts3d, uv, valid, cam, generator, iters,
                   indices=(torch.from_numpy(np.array(idx)),), **kw)

    def twin_check(uv_a, uv_b, valid, generator=None, indices=None, **kw):
        drawn["ep"] += 1
        idx = JR._sample_indices(key, jnp.asarray(valid.numpy()), 128, 8)
        return check(uv_a, uv_b, valid, generator, indices=torch.from_numpy(np.array(idx)),
                     **kw)

    monkeypatch.setattr(R, "ransac_pnp", twin_pnp)
    monkeypatch.setattr(EP, "check_hypothesis", twin_check)
    loops = []
    for i, ((f, descf), pose) in enumerate(ticks):
        a = js.process(JFrame(*(jnp.asarray(x) for x in f)), pose, np.eye(6) * 1e-4,
                       stamp=float(i + 1), descf=descf)
        b = ts.process(FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f)), pose,
                       np.eye(6) * 1e-4, stamp=float(i + 1), descf=descf)
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
        for k in ("Loop/Highest hypothesis id/", "Loop/Accepted hypothesis id/",
                  "Loop/Epipolar pairs/", "Loop/Epipolar inliers/", "Loop/Visual inliers/",
                  "Loop/Visual matches/", "Loop/Rejected by optimization/"):
            assert b.get(k) == a.get(k), (i, k)
        np.testing.assert_allclose(b.get("Loop/Highest hypothesis value/"),
                                   a.get("Loop/Highest hypothesis value/"), atol=1e-5)
        assert set(b.data) == set(a.data), i
        assert _links(ts) == _links(js), i
        loops.append(b.loop_closure_id)
    assert sum(lc > 0 for lc in loops) == 2 and drawn["pnp"] >= 2 and drawn["ep"] >= 2
    assert ts.memory.cor_nn_type == 6 and ts.memory.matcher_calls >= 2
    assert ts.memory.py_matcher.calls >= 4      # two registrations, two epipolar checks
    for i, s in ts.memory.signatures.items():
        np.testing.assert_array_equal(s.descf, js.memory.signatures[i].descf)
        for j, lk in s.links.items():
            if lk.type == LINK_GLOBAL_CLOSURE:
                np.testing.assert_allclose(
                    lk.transform, np.asarray(js.memory.signatures[i].links[j].transform),
                    atol=1e-4)


def test_descf_is_kept_only_for_the_matcher():
    """process(descf=...) stores the float descriptors with Vis/CorNNType 6
    only, as the twin does; landmarks stay refused."""
    f = FrameFeatures(torch.zeros((8, 2)), torch.ones((8, 256), dtype=torch.int8),
                      torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool),
                      torch.zeros(8, dtype=torch.bool), torch.zeros(8), torch.ones(8))
    descf = torch.rand((8, 256))
    for nn_type, kept in ((1, False), (6, True)):
        slam = Rtabmap(C.CameraModel.make(*CAM),
                       Parameters({"Vis/CorNNType": nn_type, "Tpu/VocabularyCapacity": 1024}),
                       node_capacity=8, words_per_frame=8, device="cpu")
        st = slam.process(f, np.eye(3, 4), descf=descf)
        sig = slam.memory.get(st.ref_id)
        assert (sig.descf is not None) == kept
        if kept:
            np.testing.assert_array_equal(sig.descf, descf.numpy())
    with pytest.raises(NotImplementedError, match="landmarks"):
        slam.process(f, np.eye(3, 4), landmarks=[object()])


@pytest.fixture(scope="module")
def learned_sigs(ticks):
    """The ticks' poses 0, 1 and 0 again (the revisit) as signatures."""
    out = []
    for t in (0, 1, 11):
        (uv, desc, pts3d, valid, valid3d, _angle, _resp), descf = ticks[t][0]
        out.append({"desc": desc, "uv": uv, "pts3d": pts3d, "valid3d": valid3d & valid,
                    "descf": descf, "pose": ticks[t][1]})
    return out


def _memories(sigs, over):
    jm = JMEM.Memory(JParams(over), node_capacity=8, words_per_frame=K)
    pm = MEM.Memory(Parameters(over), node_capacity=8, words_per_frame=K, device="cpu")
    for i, s in enumerate(sigs):
        for mem, Sig in ((jm, JMEM.Signature), (pm, MEM.Signature)):
            mem.signatures[i + 1] = Sig(id=i + 1, map_id=0, stamp=float(i), pose=s["pose"],
                                        desc=s["desc"], uv=s["uv"], pts3d=s["pts3d"],
                                        valid3d=s["valid3d"], descf=s["descf"])
    return jm, pm


def _indices(jm, a, b, key):
    """The twin's PnP samples for pair a -> b: its matches, then its draws."""
    _, ok, _ = jm.py_matcher.match(
        jnp.asarray(a["descf"]), jnp.asarray(a["uv"]), jnp.full((K,), 0.5),
        jnp.asarray(a["desc"].any(1)), jnp.asarray(b["descf"]), jnp.asarray(b["uv"]),
        jnp.full((K,), 0.5), jnp.asarray(b["desc"].any(1)), image_wh=(160.0, 120.0),
        threshold=jm.pymatcher_threshold)
    w = jnp.asarray(ok) & jnp.asarray(a["valid3d"])
    return (torch.from_numpy(np.array(JR._sample_indices(key, w, ITERS, 6))),)


def test_superglue_registration_matches_the_twin(learned_sigs):
    over = {"Vis/CorNNType": 6, "Tpu/VocabularyCapacity": 1024}
    jm, pm = _memories(learned_sigs, over)
    jcam, cam = JC.CameraModel.make(*CAM), C.CameraModel.make(*CAM)
    key = jax.random.PRNGKey(3)
    j = jm.compute_transform(1, 3, jcam, key)
    assert jm.py_matcher is not None and j[0] is not None
    p = pm.compute_transform(1, 3, cam, indices=_indices(jm, learned_sigs[0],
                                                         learned_sigs[2], key))
    assert pm.matcher_calls == 1 and pm.py_matcher.calls == 1
    assert p[2] == j[2] and p[2] >= 20
    np.testing.assert_allclose(p[0], np.asarray(j[0]), atol=1e-4)
    for k in ("matches", "inliers"):
        assert pm.last_registration[k] == jm.last_registration[k], k
    # the batch registers each pair on its own, with the twin's split keys
    keys, subs = key, []
    for _ in range(2):
        keys, sub = jax.random.split(keys)
        subs.append(sub)
    jb = jm.compute_transform_batch([1, 2], 3, jcam, key, [None, None])
    idx = [_indices(jm, learned_sigs[i], learned_sigs[2], subs[i])[0] for i in (0, 1)]
    pb = pm.compute_transform_batch([1, 2], 3, cam, None, [None, None],
                                    indices=(torch.stack(idx),))
    for (tp, _cp, ip), (tj, _cj, ij) in zip(pb, jb):
        assert ip == ij and (tp is None) == (tj is None)
        if tj is not None:
            np.testing.assert_allclose(tp, np.asarray(tj), atol=1e-4)
    assert [t is None for t, _, _ in pb] == [False, True]
    assert pm.matcher_calls == 3


def test_matcher_weights_resolution(learned_sigs, tmp_path):
    """PyMatcher/Path selects official weights in both packages; a missing
    file raises in the port (the twin falls back to NNDR: a deliberate
    difference)."""
    params = CV.convert_superglue(_state_dict("magicleap", n_layers=2))
    path = str(tmp_path / "official.npz")
    SGO.save_params(params, path)
    jm, pm = _memories(learned_sigs, {"Vis/CorNNType": 6, "PyMatcher/Path": path,
                                      "Tpu/VocabularyCapacity": 1024})
    jcam, cam = JC.CameraModel.make(*CAM), C.CameraModel.make(*CAM)
    j = jm.compute_transform(1, 2, jcam, jax.random.PRNGKey(0))
    p = pm.compute_transform(1, 2, cam, generator=torch.Generator().manual_seed(0))
    assert pm.superglue_params is not None and pm.py_matcher is None
    assert pm.last_registration["matches"] == jm.last_registration["matches"]
    assert (p[0] is None) == (j[0] is None)
    _, pm2 = _memories(learned_sigs, {"Vis/CorNNType": 6, "Tpu/VocabularyCapacity": 1024,
                                      "PyMatcher/Path": str(tmp_path / "missing.npz")})
    with pytest.raises(FileNotFoundError):
        pm2.compute_transform(1, 2, cam, generator=torch.Generator())
    assert pm2.cor_nn_type == 6
    pm2.set_superglue(params)
    assert pm2._ensure_matcher() and pm2.superglue_params["bin_score"].dtype == torch.float32


@pytest.mark.slow
def test_port_engine_runs_learned_detector_and_matcher():
    """The port's twin of tests/test_learned_stack.py's engine test: its own
    SuperPoint features on the CPU, the bundled matcher, closures found."""
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.datasets import synthetic as S
    from rtabmap_tpu_torch.utils import metrics

    cam = C.CameraModel.make(300.0, 300.0, 160.0, 120.0, 320, 240)
    p = Parameters({"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6})
    fe = FeatureExtractor(cam, p, max_kp=384, device="cpu")
    slam = Rtabmap(cam, p, node_capacity=128, words_per_frame=384, device="cpu")
    n_loop, n_extra = 36, 8
    poses = np.concatenate([S.loop_trajectory(n_loop), S.loop_trajectory(n_loop)[:n_extra]])
    closures = 0
    for i in range(n_loop + n_extra):
        g, d = S.render(poses[i], cam, device="cpu")
        fr, descf = fe.extract(g, d)
        assert descf is not None
        st = slam.process(fr, poses[i], np.eye(6) * 1e-4, stamp=float(i), descf=descf)
        closures += int(st.loop_closure_id > 0)
    assert closures >= 1, "learned stack found no closures"
    assert slam.memory.py_matcher is not None and slam.memory.cor_nn_type == 6
    assert any(s.descf is not None for s in slam.memory.signatures.values())
    opt = slam.get_optimized_poses()
    est = np.stack([opt[i] for i in sorted(opt)])
    assert np.isfinite(est).all()
    assert metrics.ate_rmse(est, poses[: len(est)]) < 0.2

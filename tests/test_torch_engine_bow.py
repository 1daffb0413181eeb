"""The appearance-only slice as a whole: the JAX engine and the port's, both
with RGBD/Enabled=false, on the same inputs.

Tolerances, with their reasons:
- closure ids, hypothesis ids, transfer/retrieval counts, n_words, WM id
  lists, word ids and statistic keys: exact;
- hypothesis value: 1e-4 absolute — float32 likelihood and posterior sums
  run in another order (gather vs compare-reduce, index_add_)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FeatureExtractor as JExtractor
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import FeatureExtractor as TExtractor
from rtabmap_tpu_torch.datasets.synthetic import FeatureWorld as TWorld
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap as TRtabmap
from rtabmap_tpu_torch.engine.state import SIGNATURE_FIELDS, engine_from_numpy
from rtabmap_tpu_torch.geometry import camera as TC
from rtabmap_tpu_torch.utils.params import Parameters as TParams
from torch_port_threads import one_torch_thread  # noqa: F401

K = 128
# __graft_entry__._dryrun_engine_sharded's way list: 16 ways out, then a
# revisit of the first 6 (nudged 1 cm)
WAYS = list(range(16)) + list(range(6))
OVERRIDES = {"Tpu/VocabularyCapacity": 8192, "Rtabmap/LoopThr": 0.05,
             "Rtabmap/MemoryThr": 6, "RGBD/Enabled": False}
CAM = (300.0, 300.0, 160.0, 120.0, 320, 240)


def _engines(node_capacity=32):
    jcam, tcam = JC.CameraModel.make(*CAM), TC.CameraModel.make(*CAM)
    js = JRtabmap(jcam, JParams(OVERRIDES), node_capacity=node_capacity, words_per_frame=K)
    ts = TRtabmap(tcam, TParams(OVERRIDES), node_capacity=node_capacity,
                  words_per_frame=K, device="cpu")
    return jcam, tcam, js, ts


def _tick(slam, world, i, way):
    pose = world.pose(way, nudge=0.01 if i >= 16 else 0.0)
    return slam.process(world.frame(way, i), pose, stamp=float(i))


def _assert_same_tick(a, b, js, ts):
    assert b.loop_closure_id == a.loop_closure_id
    for key in ("Loop/Highest hypothesis id/", "Memory/Transferred/",
                "Memory/Signatures retrieved/", "Loop/Accepted hypothesis id/"):
        assert b.get(key) == a.get(key), key
    assert abs(b.get("Loop/Highest hypothesis value/")
               - a.get("Loop/Highest hypothesis value/")) <= 1e-4
    assert ts.memory.vocab.n_words == js.memory.vocab.n_words
    assert list(ts.memory.wm) == list(js.memory.wm)
    assert set(b.data) == set(a.data)


def test_feature_world_ticks_match():
    jcam, tcam, js, ts = _engines()
    jw, tw = JS.FeatureWorld(jcam, n_ways=24, K=K), TWorld(tcam, n_ways=24, K=K, device="cpu")
    closures = transferred = retrieved = 0
    for i, w in enumerate(WAYS):
        a, b = _tick(js, jw, i, w), _tick(ts, tw, i, w)
        _assert_same_tick(a, b, js, ts)
        closures += a.loop_closure_id > 0
        transferred += int(a.get("Memory/Transferred/"))
        retrieved += int(a.get("Memory/Signatures retrieved/"))
    assert closures > 0 and transferred > 0 and retrieved > 0
    np.testing.assert_allclose(ts.bayes.posterior.numpy(), np.asarray(js.bayes.posterior),
                               atol=1e-5)


def test_rendered_frames_through_entry_points_match():
    W, H, kp = 160, 120, 64
    jcam = JC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    tcam = TC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    over = {"RGBD/Enabled": False, "Tpu/VocabularyCapacity": 4096, "Rtabmap/LoopThr": 0.05}
    js = JRtabmap(jcam, JParams(over), node_capacity=32, words_per_frame=kp)
    ts = TRtabmap(tcam, TParams(over), node_capacity=32, words_per_frame=kp, device="cpu")
    jfe = JExtractor(jcam, JParams(over), max_kp=kp)
    tfe = TExtractor(tcam, TParams(over), max_kp=kp, device="cpu")
    poses = np.asarray(JS.loop_trajectory(24))[[0, 1, 2, 3, 0, 1]]
    for i, pose in enumerate(poses):
        gray, _ = JS.render(jnp.asarray(pose), jcam)
        gray = np.asarray(gray)
        a = js.process(jfe.extract(jnp.asarray(gray), None)[0], pose, stamp=float(i))
        b = ts.process(tfe.extract(gray, None)[0], pose, stamp=float(i))
        np.testing.assert_array_equal(ts.memory.get(b.ref_id).word_ids,
                                      js.memory.get(a.ref_id).word_ids)
        _assert_same_tick(a, b, js, ts)


def _jax_state(js):
    """The JAX engine's state as numpy, in engine_from_numpy's layout."""
    mem = js.memory
    sigs = []
    for s in mem.signatures.values():
        rec = {k: getattr(s, k) for k in SIGNATURE_FIELDS}
        rec["links"] = [(j, lk.type, np.asarray(lk.transform), np.asarray(lk.information))
                        for j, lk in s.links.items()]
        sigs.append(rec)
    return {
        "vocab": mem.vocab.state_dict(),
        "node_words": np.asarray(mem.node_words), "node_valid": np.asarray(mem.node_valid),
        "node_uv": np.asarray(mem.node_uv), "node_pts": np.asarray(mem.node_pts),
        "word_nw": np.asarray(mem.word_nw), "host_valid": mem.host_valid,
        "host_wm": mem.host_wm, "slot_to_id": mem._slot_to_id,
        "free_slots": list(mem._free_slots), "signatures": sigs,
        "stm": list(mem.stm), "wm": list(mem.wm), "next_id": mem._next_id,
        "map_id": mem._map_id, "n_inter_wm": mem.n_inter_wm,
        "posterior": np.asarray(js.bayes.posterior),
        "last_hypothesis": js.last_hypothesis, "loop_closure_id": js.loop_closure_id,
        "last_pose": js._last_pose, "distance_travelled": js._distance_travelled,
        "distance_at_last_loc": js._distance_at_last_loc,
        "last_process_stamp": js._last_process_stamp,
        "optimized_poses": dict(js.optimized_poses),
    }


@pytest.mark.parametrize("n_before", [17, 20], ids=["retrieving", "revisiting"])
def test_carried_state_next_tick_matches(n_before):
    jcam, tcam, js, _ = _engines()
    jw, tw = JS.FeatureWorld(jcam, n_ways=24, K=K), TWorld(tcam, n_ways=24, K=K, device="cpu")
    for i, w in enumerate(WAYS[:n_before]):
        _tick(js, jw, i, w)
    ts = engine_from_numpy(tcam, TParams(OVERRIDES), _jax_state(js), device="cpu")
    i, w = n_before, WAYS[n_before]
    a, b = _tick(js, jw, i, w), _tick(ts, tw, i, w)
    assert a.get("Loop/Highest hypothesis id/") > 0
    _assert_same_tick(a, b, js, ts)
    assert ts.get_highest_hypothesis()[0] == js.get_highest_hypothesis()[0]

"""The metric RGB-D tick as a whole: the JAX engine and the port's, both
with the default RGBD/Enabled=true, on the same features and the same
ground-truth odometry.

Frames: 160x120 renders (fx = fy = 120) of ``loop_trajectory(48)``,
positions 0..8 and then 2, 1, 0 again (12 ticks, 0.196 m and 7.5 degrees
a step, above the RGBD/LinearUpdate gate), 128 GFTT/BRIEF keypoints
extracted once by the JAX package and fed to both engines as the same
numpy arrays, with Mem/STMSize 2 so that the revisit can close with the
way out: the first revisit by proximity (its appearance hypothesis falls
to the loop-ratio rule), the next ones by appearance. The
odometry is the ground truth and the frames are noise-free, so every good
RANSAC hypothesis refines to the same pose: the engines draw their
samples differently (a torch generator against jax.random) and must
still agree.

Tolerances and why: closure ids, hypothesis ids, proximity counts, link
sets (endpoints and types), statistic keys and the WM/STM id lists
exactly; optimized poses within 1e-3 (RANSAC picks other hypotheses, the
link information comes from a quartile covariance, and the graph solve is
float32); the slow end-to-end twin holds the port to the bounds of
tests/test_slam_e2e.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FrameFeatures as JFrame
from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

K = 128
CAM = (120.0, 120.0, 80.0, 60.0, 160, 120)
OVERRIDES = {"Tpu/VocabularyCapacity": 8192, "Mem/STMSize": 2}
WAY = list(range(9)) + [2, 1, 0]


@pytest.fixture(scope="module")
def ticks():
    jcam = JC.CameraModel.make(*CAM)
    ex = jax.jit(lambda g, d: extract_features(g, d, jcam, K))
    poses = np.asarray(JS.loop_trajectory(48))
    feats = {}
    for w in sorted(set(WAY)):
        feats[w] = tuple(np.asarray(x) for x in ex(*JS.render(jnp.asarray(poses[w]), jcam)))
    return [(feats[w], poses[w]) for w in WAY]


def _links(slam):
    return sorted((i, j, lk.type) for i, s in slam.memory.signatures.items()
                  for j, lk in s.links.items())


def test_rgbd_ticks_match_the_jax_engine(ticks):
    js = JRtabmap(JC.CameraModel.make(*CAM), JParams(OVERRIDES), node_capacity=32,
                  words_per_frame=K)
    ts = Rtabmap(C.CameraModel.make(*CAM), Parameters(OVERRIDES), node_capacity=32,
                 words_per_frame=K, device="cpu")
    closures = proximity = 0
    for i, (f, pose) in enumerate(ticks):
        a = js.process(JFrame(*(jnp.asarray(x) for x in f)), pose, stamp=float(i + 1))
        b = ts.process(FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f)), pose,
                       stamp=float(i + 1))
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
        for key in ("Loop/Highest hypothesis id/", "Loop/Accepted hypothesis id/",
                    "Proximity/Space links added/", "Proximity/Space paths/",
                    "Proximity/Space visual paths checked/", "Memory/Small movement/",
                    "Loop/Rejected by optimization/", "Loop/Optimization incremental/"):
            assert b.get(key) == a.get(key), (i, key)
        assert set(b.data) == set(a.data), i
        assert _links(ts) == _links(js), i
        assert list(ts.memory.wm) == list(js.memory.wm)
        assert list(ts.memory.stm) == list(js.memory.stm)
        jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
        assert sorted(jo) == sorted(to)
        for k in jo:
            np.testing.assert_allclose(to[k], np.asarray(jo[k]), atol=1e-3, err_msg=str(k))
        closures += int(a.loop_closure_id > 0)
        proximity += int(a.get("Proximity/Space links added/"))
    assert closures >= 1 and proximity >= 1      # both closure kinds ran


def test_render_sequence_matches_the_twin():
    """The renderer's sequence helper, noise-free, against the JAX twin
    (1e-5: float32 ray-box intersections in another order)."""
    from rtabmap_tpu_torch.datasets.synthetic import render_sequence

    poses = np.asarray(JS.loop_trajectory(48))[:3]
    jg, jd = JS.render_sequence(jnp.asarray(poses), JC.CameraModel.make(*CAM))
    g, d = render_sequence(poses, C.CameraModel.make(*CAM), device="cpu")
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)


def test_default_parameters_construct_and_refuse_what_is_not_ported():
    cam = C.CameraModel.make(*CAM)
    slam = Rtabmap(cam, Parameters({"Tpu/VocabularyCapacity": 1024}), node_capacity=16,
                   words_per_frame=8, device="cpu")
    assert slam.rgbd_mode and slam.incremental_optimization
    # epipolar verification and intermediate nodes are ported
    assert Rtabmap(cam, Parameters({"VhEp/Enabled": True, "Tpu/VocabularyCapacity": 1024}),
                   node_capacity=16, words_per_frame=8, device="cpu").vh_ep_enabled
    from rtabmap_tpu_torch.memory.db import Database

    db = Database(":memory:", async_writes=False)    # the map store is ported
    assert Rtabmap(cam, Parameters({"Tpu/VocabularyCapacity": 1024}), db=db,
                   node_capacity=16, words_per_frame=8, device="cpu").memory.db is db
    db.close()
    assert Rtabmap(cam, Parameters({"Rtabmap/CreateIntermediateNodes": True,
                                    "Tpu/VocabularyCapacity": 1024}),
                   node_capacity=16, words_per_frame=8,
                   device="cpu").create_intermediate_nodes
    # what stays refused: landmarks and learned float descriptors
    with pytest.raises(NotImplementedError, match="landmarks"):
        slam.process(None, np.eye(3, 4), landmarks=[object()])
    with pytest.raises(NotImplementedError, match="learned"):
        slam.process(None, np.eye(3, 4), descf=np.zeros((8, 256), np.float32))


@pytest.mark.slow
def test_port_slam_loop_closure_improves_ate():
    """The port's twin of tests/test_slam_e2e.py on the CPU: the same
    58-frame sequence through run_dataset, held to the same bounds."""
    from rtabmap_tpu_torch.tools.rgbd_laps import run_sequence

    out = run_sequence("parity", device="cpu")
    assert out["lost"] == 0
    assert out["loops"] >= 1, "no loop closures accepted on revisit"
    assert out["optimized_poses"] == out["frames"] == 58
    assert out["ate_slam"] <= out["ate_odom"] * 1.1, (out["ate_slam"], out["ate_odom"])
    assert out["ate_slam"] < 0.08
    st = out["run"]["slam"].stats_history[-1]
    assert "Timing/Total/ms" in st.data
    assert st.get("Memory/Working memory size/") > 0
    assert st.get("Keypoint/Dictionary size/words") > 1000

"""Localization mode (``Mem/IncrementalMemory`` false): the port against the
JAX package.

- The odometry-cache check (twins of tests/test_odom_cache.py): the same
  primed cache and localization links through both engines'
  ``_localize_with_odom_cache``; a consistent localization is accepted at
  the same pose (within 1e-3: a 12-step float32 LM on a 5-node graph
  whose priors weigh 1e6) and kept in the cache, a teleporting one is
  rejected by both with the same worst edge-error ratio (within 1e-2
  relative).
- A frozen map (twin of tests/test_localization.py's
  ``test_localization_against_frozen_map``, on the port alone at 160x120):
  map, close, reload in localization mode, relocalize a restarted
  odometry; the bounds are the twin's. ``set_initial_pose`` places the
  next frame (to 1e-6: host float32 compositions).
- The same through both engines (slow: the JAX engine's compiles): the
  same features (extracted once by the JAX package) and ground-truth
  odometry, each engine mapping into its own store and localizing
  against it: the same frames localized against the same nodes, the
  localized poses within 1e-3, as the RGB-D engine parity
  (tests/test_torch_engine_rgbd.py) holds its ticks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.memory.memory import LINK_GLOBAL_CLOSURE as J_GLOBAL
from rtabmap_tpu.memory.memory import LINK_NEIGHBOR as J_NEIGHBOR
from rtabmap_tpu.memory.memory import Link as JLink
from rtabmap_tpu.utils.logging import Statistics as JStatistics
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import FeatureExtractor, FrameFeatures
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.memory.memory import LINK_GLOBAL_CLOSURE, LINK_NEIGHBOR, Link
from rtabmap_tpu_torch.utils.logging import Statistics
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = (120.0, 120.0, 80.0, 60.0, 160, 120)
LOC = {"Mem/IncrementalMemory": False, "RGBD/MaxOdomCacheSize": 10,
       "RGBD/OptimizeMaxError": 3.0, "Tpu/VocabularyCapacity": 8192}


def _pose(x, y=0.0):
    p = np.eye(3, 4, dtype=np.float32)
    p[0, 3], p[1, 3] = x, y
    return p


class _Sig:
    def __init__(self, sid):
        self.id = sid


def _engines():
    js = JRtabmap(JC.CameraModel.make(*CAM), JParams(LOC), node_capacity=64, words_per_frame=64)
    ts = Rtabmap(C.CameraModel.make(*CAM), Parameters(LOC), node_capacity=64, words_per_frame=64,
                 device="cpu")
    return js, ts


def _prime(slam, ids_x, link):
    """A straight-line walk in the odometry cache."""
    prev = None
    for sid, x in ids_x:
        if prev is not None:
            pid, px = prev
            slam._odom_cache_links[(pid, sid)] = link(
                pid, sid, _pose(x - px), np.eye(6, dtype=np.float32) * 1e4)
        slam._odom_cache_poses[sid] = _pose(x)
        prev = (sid, x)


def _both(map_poses, walk, loc_links):
    """Prime both engines alike, then run each localization in turn;
    returns [(jax result, port result, jax max-error, port max-error)]."""
    js, ts = _engines()
    for slam, link in ((js, lambda *a: JLink(a[0], a[1], J_NEIGHBOR, *a[2:])),
                       (ts, lambda *a: Link(a[0], a[1], LINK_NEIGHBOR, *a[2:]))):
        for i, p in map_poses.items():
            slam.optimized_poses[i] = p
        _prime(slam, walk, link)
    out = []
    for a, b, t, odom in loc_links:
        info = np.eye(6, dtype=np.float32) * 1e2
        sj, st = JStatistics(), Statistics()
        rj = js._localize_with_odom_cache(_Sig(b), [JLink(a, b, J_GLOBAL, t, info)], odom, sj)
        rt = ts._localize_with_odom_cache(_Sig(b), [Link(a, b, LINK_GLOBAL_CLOSURE, t, info)],
                                          odom, st)
        out.append((rj, rt, sj.get("Loop/Optimization max error ratio/"),
                    st.get("Loop/Optimization max error ratio/")))
    return js, ts, out


def test_consistent_localization_accepted():
    js, ts, [(rj, rt, _, _)] = _both({1: _pose(0.0)}, [(10, 0.0), (11, 0.5), (12, 1.0)],
                                     [(1, 12, _pose(1.0), _pose(1.0))])
    assert rj is not None and rt is not None
    np.testing.assert_allclose(rt, np.asarray(rj), atol=1e-3)
    np.testing.assert_allclose(rt[:3, 3], [1.0, 0, 0], atol=1e-2)
    assert (1, 12) in ts._odom_cache_links and (1, 12) in js._odom_cache_links
    np.testing.assert_allclose(ts._odom_cache_links[(1, 12)].transform,
                               np.asarray(js._odom_cache_links[(1, 12)].transform), atol=1e-3)


def test_inconsistent_localization_rejected():
    """After a good localization at x = 0, a link putting the robot on a
    node 10 m away, where odometry allows 1 m, is rejected by both."""
    _, _, [(gj, gt, _, _), (rj, rt, ej, et)] = _both(
        {1: _pose(0.0), 2: _pose(10.0)}, [(10, 0.0), (11, 0.5), (12, 1.0)],
        [(1, 10, _pose(0.0), _pose(0.0)), (2, 12, _pose(0.0), _pose(1.0))])
    np.testing.assert_allclose(gt, np.asarray(gj), atol=1e-3)
    assert rj is None and rt is None, "teleporting localization was accepted"
    assert et > 3.0 and abs(et - ej) <= 1e-2 * ej


def _port_frames(ways, cam, n_loop=48, k=128):
    fe = FeatureExtractor(cam, max_kp=k, device="cpu")
    poses = loop_trajectory(n_loop)
    return {w: (fe.extract(*render(poses[w], cam, device="cpu"))[0], poses[w]) for w in ways}


def test_localization_against_frozen_map(tmp_path):
    """Map every other frame of a 48-frame loop with ground-truth
    odometry, close, reload in localization mode and restart the odometry
    at the identity at frame 20: the robot relocalizes within 0.1 m, WM
    holds only the stored nodes, and the node count stays within the STM
    ring plus a margin."""
    cam = C.CameraModel.make(*CAM)
    frames = _port_frames(range(0, 48, 2), cam)
    path = str(tmp_path / "map.db")
    db = Database(path)
    slam = Rtabmap(cam, Parameters({"Tpu/VocabularyCapacity": 8192}), db=db, node_capacity=64,
                   words_per_frame=128, device="cpu")
    for i in range(0, 48, 2):
        slam.process(frames[i][0], frames[i][1], np.eye(6) * 1e-4, stamp=float(i + 1))
    slam.close()
    db.close()

    db2 = Database(path)
    loc = Rtabmap.load(db2, cam, Parameters(LOC), node_capacity=64, words_per_frame=128,
                       device="cpu")
    n_map_nodes = len(loc.memory.signatures)
    T0 = frames[20][1]
    errs = []
    for i in range(20, 30, 2):
        st = loc.process(frames[i][0], T.np_relative(T0, frames[i][1]), np.eye(6) * 1e-4,
                         stamp=float(100 + i))
        if st.get("Loop/Localized/"):
            cur = loc.optimized_poses[st.ref_id]
            errs.append(T.np_translation_norm(T.np_relative(cur, frames[i][1])))
    assert errs, "never localized against the map"
    assert min(errs) < 0.1, errs
    assert len(loc.memory.wm) == len([s for s in loc.memory.signatures.values()
                                      if s.map_id == 0 and not s.in_ltm])
    assert len(loc.memory.signatures) <= n_map_nodes + loc.memory.stm_size + 6
    db2.close()
    db3 = Database(path, async_writes=False)   # the stored map did not change
    assert sum(1 for r in db3.node_infos() if r["map_id"] == 0) == n_map_nodes
    db3.close()


def test_set_initial_pose_places_the_next_frame():
    """``set_initial_pose`` seeds the map correction: the next frame sits
    at the given map pose, and later frames follow their odometry from it
    (the JAX twin's rule: correction = pose * odometry^-1)."""
    cam = C.CameraModel.make(*CAM)
    frames = _port_frames([0, 2], cam)
    loc = Rtabmap(cam, Parameters(LOC), node_capacity=16, words_per_frame=128, device="cpu")
    start = _pose(3.0, -1.0)
    loc.set_initial_pose(start)
    odom0, odom1 = _pose(0.5), _pose(0.9, 0.1)
    a = loc.process(frames[0][0], odom0, stamp=1.0)
    b = loc.process(frames[2][0], odom1, stamp=2.0)
    np.testing.assert_allclose(loc.optimized_poses[a.ref_id], start, atol=1e-6)
    np.testing.assert_allclose(loc.optimized_poses[b.ref_id],
                               T.np_compose(start, T.np_relative(odom0, odom1)), atol=1e-6)


@pytest.mark.slow
def test_localization_matches_the_jax_engine(tmp_path):
    from rtabmap_tpu.core.frame import FrameFeatures as JFrame
    from rtabmap_tpu.core.frame import extract_features
    from rtabmap_tpu.datasets import synthetic as JS
    from rtabmap_tpu.memory.db import Database as JDatabase

    jcam = JC.CameraModel.make(*CAM)
    ex = jax.jit(lambda g, d: extract_features(g, d, jcam, 128))
    poses = np.asarray(JS.loop_trajectory(48))
    feats = {w: tuple(np.asarray(x) for x in ex(*JS.render(jnp.asarray(poses[w]), jcam)))
             for w in range(0, 48, 2)}
    jf = lambda w: JFrame(*(jnp.asarray(x) for x in feats[w]))  # noqa: E731
    tf = lambda w: FrameFeatures(*(torch.from_numpy(np.array(x)) for x in feats[w]))  # noqa: E731
    mapped = list(range(0, 24, 2))
    kw = dict(node_capacity=32, words_per_frame=128)
    jdb, tdb = JDatabase(str(tmp_path / "j.db")), Database(str(tmp_path / "t.db"))
    js = JRtabmap(jcam, JParams({"Tpu/VocabularyCapacity": 8192}), db=jdb, **kw)
    ts = Rtabmap(C.CameraModel.make(*CAM), Parameters({"Tpu/VocabularyCapacity": 8192}), db=tdb,
                 device="cpu", **kw)
    for k, w in enumerate(mapped):
        js.process(jf(w), poses[w], stamp=float(k + 1))
        ts.process(tf(w), poses[w], stamp=float(k + 1))
    for slam, db in ((js, jdb), (ts, tdb)):
        slam.close()
        db.close()
    jdb, tdb = JDatabase(str(tmp_path / "j.db")), Database(str(tmp_path / "t.db"))
    js = JRtabmap.load(jdb, jcam, JParams(LOC), **kw)
    ts = Rtabmap.load(tdb, C.CameraModel.make(*CAM), Parameters(LOC), device="cpu", **kw)
    T0 = poses[8]
    localized = 0
    for k, w in enumerate(range(8, 20, 2)):
        odom = T.np_relative(T0, poses[w])
        a = js.process(jf(w), odom, stamp=float(100 + k))
        b = ts.process(tf(w), odom, stamp=float(100 + k))
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), w
        for key in ("Loop/Localized/", "Loop/Highest hypothesis id/",
                    "Loop/Accepted hypothesis id/", "Proximity/Space links added/",
                    "Loop/Rejected by optimization/", "Memory/Odom cache poses/"):
            assert b.get(key) == a.get(key), (w, key)
        assert set(b.data) == set(a.data), w
        assert list(ts.memory.wm) == list(js.memory.wm)
        np.testing.assert_allclose(ts.optimized_poses[b.ref_id],
                                   np.asarray(js.optimized_poses[a.ref_id]), atol=1e-3)
        localized += int(b.get("Loop/Localized/"))
    assert localized >= 1
    jdb.close()
    tdb.close()

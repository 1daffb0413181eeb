"""The engine's scan stages, epipolar verification and intermediate nodes:
the port's ``Rtabmap`` against the JAX engine on the same features
(extracted once by the JAX package and fed to both as numpy arrays), the
same scans and the same odometry.

- neighbour-link refining (the twin of tests/test_neighbor_refining.py's
  first test): a biased odometry link polished by scan ICP;
- the scan-ICP proximity fallback (its second test): random images, so no
  visual registration, and a square path back to its start;
- global scan-map localization (the twin of tests/test_localization.py's
  ``test_scan_localization_global_scan_map``) at 16 x 48 scans;
- VhEp accept and reject on the same signatures with the JAX twin's RANSAC
  samples injected;
- intermediate nodes (``Rtabmap/DetectionRate`` 0.5, stamps 1 s apart).

Tolerances and why: ids, flags, counts, link sets (endpoints and types),
statistic keys and the epipolar pair and inlier counts exactly (integer
outputs); refined and scan-closure transforms and optimized poses within
1e-3 m (float32 ICP: normals and Gauss-Newton steps summed in another
order); refining statistics within 1e-3 relative (they inherit the ICP's
last iteration)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import FrameFeatures as JFrame
from rtabmap_tpu.core.frame import extract_features
from rtabmap_tpu.core.laser_scan import ScanFormat as JScanFormat
from rtabmap_tpu.core.laser_scan import make_scan as jmake_scan
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.utils.logging import Statistics as JStatistics
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.core.laser_scan import ScanFormat, make_scan
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.ops import epipolar as EP
from rtabmap_tpu_torch.utils.logging import Statistics
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = (160.0, 160.0, 79.5, 59.5, 160, 120)


@functools.lru_cache(maxsize=None)
def _extractor(k):
    jcam = JC.CameraModel.make(*CAM)
    return jax.jit(lambda g, d: extract_features(g, d, jcam, k))


def _feats(gray, depth, k):
    return tuple(np.asarray(x) for x in _extractor(k)(jnp.asarray(gray), jnp.asarray(depth)))


def _pair(feats):
    return (JFrame(*(jnp.asarray(x) for x in feats)),
            FrameFeatures(*(torch.from_numpy(np.array(x)) for x in feats)))


def _room_scan(pose_wc, n=512, seed=0):
    """tests/test_neighbor_refining.py's scan: points on a square room's
    walls in the sensor frame at ``pose_wc`` (numpy)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    dx, dz = np.cos(ang), np.sin(ang)
    t = np.minimum(3.0 / np.maximum(np.abs(dx), 1e-6), 3.0 / np.maximum(np.abs(dz), 1e-6))
    pts_w = np.stack([dx * t, rng.uniform(-0.1, 0.1, n), dz * t], 1).astype(np.float32)
    Tcw = np.asarray(JT.inverse(jnp.asarray(pose_wc)))
    return (pts_w @ Tcw[:, :3].T + Tcw[:, 3]).astype(np.float32)


def _scans(pts, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    return (jmake_scan(jnp.asarray(pts), fmt=JScanFormat.XYZ, valid=jnp.asarray(valid)),
            make_scan(pts, ScanFormat.XYZ, valid=valid, device="cpu"))


def _engines(over, k, capacity=64, **kw):
    return (JRtabmap(JC.CameraModel.make(*CAM), JParams(over), node_capacity=capacity,
                     words_per_frame=k, **kw),
            Rtabmap(C.CameraModel.make(*CAM), Parameters(over), node_capacity=capacity,
                    words_per_frame=k, device="cpu", **kw))


def _links(slam):
    return sorted((i, j, lk.type) for i, s in slam.memory.signatures.items()
                  for j, lk in s.links.items())


def _same_tick(a, b, i):
    assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
    assert set(b.data) == set(a.data), (i, set(b.data) ^ set(a.data))


def test_neighbor_link_refining_matches_the_jax_engine():
    poses = np.asarray(JS.loop_trajectory(64))[:3]
    grays, depths = JS.render_sequence(jnp.asarray(poses), JC.CameraModel.make(*CAM))
    feats = [_feats(grays[i], depths[i], 256) for i in range(2)]
    over = {"RGBD/NeighborLinkRefining": True, "Rtabmap/DetectionRate": 0,
            "Tpu/VocabularyCapacity": 8192}
    js, ts = _engines(over, 256)
    bias = np.asarray(JT.se3_exp(jnp.asarray([0.04, 0.0, -0.03, 0.0, 0.0, 0.0])))
    odom = [poses[0], np.asarray(JT.compose(jnp.asarray(poses[1]), jnp.asarray(bias)))]
    for i in range(2):
        jf, tf = _pair(feats[i])
        jscan, tscan = _scans(_room_scan(poses[i], seed=i))
        a = js.process(jf, odom[i], np.eye(6) * 1e-4, stamp=float(i + 1), scan=jscan)
        b = ts.process(tf, odom[i], np.eye(6) * 1e-4, stamp=float(i + 1), scan=tscan)
        _same_tick(a, b, i)
    assert b.get("Odometry/Refined by scan/") == a.get("Odometry/Refined by scan/") == 1
    for key in [k for k in a.data if k.startswith("NeighborLinkRefining/")]:
        np.testing.assert_allclose(b.get(key), a.get(key), rtol=1e-3, atol=1e-6, err_msg=key)
    lj = js.memory.get(a.ref_id - 1).links[a.ref_id]
    lt = ts.memory.get(b.ref_id - 1).links[b.ref_id]
    np.testing.assert_allclose(lt.transform, np.asarray(lj.transform), atol=1e-3)
    true_rel = np.asarray(JT.relative(jnp.asarray(poses[0]), jnp.asarray(poses[1])))
    biased = np.asarray(JT.relative(jnp.asarray(poses[0]), jnp.asarray(odom[1])))
    assert (np.linalg.norm(lt.transform[:, 3] - true_rel[:, 3])
            < 0.7 * np.linalg.norm(biased[:, 3] - true_rel[:, 3]))


def test_scan_proximity_fallback_matches_the_jax_engine():
    rng = np.random.default_rng(0)
    over = {"Rtabmap/DetectionRate": 0, "RGBD/LocalRadius": 2.0, "Rtabmap/LoopThr": 2.0,
            "Tpu/VocabularyCapacity": 8192}
    js, ts = _engines(over, 128)
    wp = np.array([[0, 0], [0.8, 0], [1.7, 0], [2.5, 0], [2.5, 0.8], [2.5, 1.7],
                   [2.5, 2.5], [1.7, 2.5], [0.8, 2.5], [0, 2.5], [0, 1.7], [0, 0.8],
                   [0.3, 0.2]], np.float32)
    icp_multi = 0
    for k, (x, z) in enumerate(wp):
        P = np.eye(3, 4, dtype=np.float32)
        P[0, 3], P[2, 3] = x, z
        g = rng.random((120, 160), np.float32)
        d = 1.0 + rng.random((120, 160), np.float32)
        jf, tf = _pair(_feats(g, d, 128))
        jscan, tscan = _scans(_room_scan(P, seed=k))
        a = js.process(jf, P, np.eye(6) * 1e-4, stamp=float(k + 1), scan=jscan)
        b = ts.process(tf, P, np.eye(6) * 1e-4, stamp=float(k + 1), scan=tscan)
        _same_tick(a, b, k)
        for key in ("Proximity/Space detections added icp multi/",
                    "Proximity/Space detections added visually/",
                    "Proximity/Space scan paths checked/", "Proximity/Space links added/"):
            assert b.get(key) == a.get(key), (k, key)
        assert _links(ts) == _links(js), k
        icp_multi += int(a.get("Proximity/Space detections added icp multi/"))
    assert icp_multi >= 1
    for i, s in js.memory.signatures.items():
        for j, lk in s.links.items():
            np.testing.assert_allclose(ts.memory.get(i).links[j].transform,
                                       np.asarray(lk.transform), atol=1e-3)
    jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
    for i in jo:
        np.testing.assert_allclose(to[i], np.asarray(jo[i]), atol=1e-3)


def test_global_scan_localization_matches_the_jax_engine(tmp_path):
    """Map 8 nodes with 16 x 48 LiDAR scans into a store (both packages,
    one store each), then localize with RGBD/ProximityGlobalScanMap from a
    start 0.25 m / 8.6 degrees off: the same frames localize, at poses
    within 1e-3 m, and within 0.1 m of the truth."""
    rng = np.random.default_rng(0)
    traj = np.asarray(JS.lidar_trajectory(16, radius=2.0))
    scans = {}
    for i in range(16):
        pts, valid = JS.lidar_scan(jnp.asarray(traj[i]), n_azimuth=48, n_rings=16)
        scans[i] = (np.array(pts), np.array(valid))
    frames = [_feats(rng.random((120, 160), np.float32),
                     1.0 + rng.random((120, 160), np.float32), 128) for _ in range(11)]
    p_map = {"Rtabmap/LoopThr": 2.0, "RGBD/LocalRadius": 0.0, "Rtabmap/DetectionRate": 0,
             "Tpu/VocabularyCapacity": 8192}
    jdb, tdb = JDatabase(str(tmp_path / "j.db")), Database(str(tmp_path / "t.db"))
    js = JRtabmap(JC.CameraModel.make(*CAM), JParams(p_map), db=jdb, node_capacity=64,
                  words_per_frame=128)
    ts = Rtabmap(C.CameraModel.make(*CAM), Parameters(p_map), db=tdb, node_capacity=64,
                 words_per_frame=128, device="cpu")
    for n, i in enumerate(range(0, 16, 2)):
        jf, tf = _pair(frames[n])
        jscan, tscan = _scans(*scans[i])
        js.process(jf, traj[i], np.eye(6) * 1e-4, stamp=float(i + 1), scan=jscan)
        ts.process(tf, traj[i], np.eye(6) * 1e-4, stamp=float(i + 1), scan=tscan)
    for slam, db in ((js, jdb), (ts, tdb)):
        slam.close()
        db.close()
    p_loc = {"Mem/IncrementalMemory": False, "Rtabmap/LoopThr": 2.0,
             "RGBD/ProximityGlobalScanMap": True, "Rtabmap/DetectionRate": 0,
             "RGBD/LocalRadius": 0.0, "Tpu/VocabularyCapacity": 8192}
    jdb, tdb = JDatabase(str(tmp_path / "j.db")), Database(str(tmp_path / "t.db"))
    jl = JRtabmap.load(jdb, JC.CameraModel.make(*CAM), JParams(p_loc), node_capacity=64,
                       words_per_frame=128)
    tl = Rtabmap.load(tdb, C.CameraModel.make(*CAM), Parameters(p_loc), node_capacity=64,
                      words_per_frame=128, device="cpu")
    start = 5
    T0 = jnp.asarray(traj[start])
    init = np.asarray(JT.compose(T0, JT.se3_exp(jnp.asarray([0.2, -0.15, 0.0, 0.0, 0.0, 0.15]))))
    jl.set_initial_pose(init)
    tl.set_initial_pose(init)
    localized = 0
    for n, i in enumerate(range(start, start + 3)):
        odom = np.asarray(JT.relative(T0, jnp.asarray(traj[i])))
        jf, tf = _pair(frames[8 + n])
        jscan, tscan = _scans(*scans[i])
        a = jl.process(jf, odom, np.eye(6) * 1e-4, stamp=float(100 + i), scan=jscan)
        b = tl.process(tf, odom, np.eye(6) * 1e-4, stamp=float(100 + i), scan=tscan)
        _same_tick(a, b, n)
        for key in ("Loop/Localized/", "Proximity/Space detections added icp global/"):
            assert b.get(key) == a.get(key), (n, key)
        np.testing.assert_allclose(tl.optimized_poses[b.ref_id],
                                   np.asarray(jl.optimized_poses[a.ref_id]), atol=1e-3)
        if b.get("Loop/Localized/"):
            localized += 1
            err = np.linalg.norm(tl.optimized_poses[b.ref_id][:, 3] - traj[i][:, 3])
            assert err < 0.1, (n, err)
    assert localized >= 1 and tl.global_scan_calls >= 1
    assert tl._global_scan_cache[0] == jl._global_scan_cache[0]
    assert tl._global_scan_cache[1].shape[0] == jl._global_scan_cache[1].shape[0]
    jdb.close()
    tdb.close()


def test_epipolar_verification_matches_the_jax_engine(monkeypatch):
    """The same two signatures verified by both engines, the port given the
    JAX twin's RANSAC samples: accepted for a true pair, rejected with the
    current frame's keypoints scrambled and with too few pairs; the pair
    and inlier counts equal."""
    poses = np.asarray(JS.loop_trajectory(32))
    grays, depths = JS.render_sequence(jnp.asarray(poses[:2]), JC.CameraModel.make(*CAM))
    feats = [_feats(grays[i], depths[i], 256) for i in range(2)]
    key = jax.random.PRNGKey(7)
    injected = []
    port_check = EP.check_hypothesis

    def check(uv_a, uv_b, valid, generator=None, **kw):
        idx = torch.from_numpy(np.array(JR._sample_indices(key, jnp.asarray(valid.numpy()),
                                                            128, 8)))
        injected.append(idx)
        return port_check(uv_a, uv_b, valid, generator, indices=idx, **kw)

    monkeypatch.setattr(EP, "check_hypothesis", check)
    results = []
    for case in ("true", "scrambled", "too-few"):
        over = {"VhEp/Enabled": True, "Tpu/VocabularyCapacity": 8192}
        if case == "too-few":
            over["VhEp/MatchCountMin"] = 10_000
        js, ts = _engines(over, 256)
        monkeypatch.setattr(js, "_split_key", lambda: key)
        sigs = []
        for slam, frame_of in ((js, lambda f: _pair(f)[0]), (ts, lambda f: _pair(f)[1])):
            a = slam.memory.create_signature(frame_of(feats[0]), poses[0], 0.0)
            b = slam.memory.create_signature(frame_of(feats[1]), poses[1], 0.0)
            sigs.append((a, b))
        (ja, jb), (ta, tb) = sigs
        np.testing.assert_array_equal(tb.word_ids, np.asarray(jb.word_ids))
        if case == "scrambled":
            uv = np.random.default_rng(0).uniform(0, 160, size=jb.uv.shape).astype(np.float32)
            jb.uv, tb.uv = uv, uv.copy()
        sj, st = JStatistics(), Statistics()
        ok_j = js._verify_hypothesis_ep(jb, ja.id, sj)
        ok_t = ts._verify_hypothesis_ep(tb, ta.id, st)
        assert ok_t == ok_j, case
        assert set(st.data) == set(sj.data), case
        for k in ("Loop/Epipolar pairs/", "Loop/Epipolar inliers/"):
            assert st.get(k) == sj.get(k), (case, k)
        results.append(ok_t)
    assert results == [True, False, False]
    assert len(injected) == 2        # the too-few case stops before the RANSAC


def test_epipolar_verification_refuses_the_learned_matcher(monkeypatch):
    """With Vis/CorNNType 6 the epipolar check takes the bundled matcher's
    pairs (the learned-model slice ported it; it used to raise): the same
    two SuperPoint signatures (a revisit of one pose, features and float
    descriptors extracted by the JAX package) verified by both engines,
    the port given the twin's RANSAC samples; the pair and inlier counts
    equal, and a signature without descf falls back to shared words."""
    from rtabmap_tpu.core.frame import FeatureExtractor as JFeatureExtractor

    jcam = JC.CameraModel.make(*CAM)
    over = {"VhEp/Enabled": True, "Vis/CorNNType": 6, "Kp/DetectorStrategy": 11,
            "Tpu/VocabularyCapacity": 8192}
    fr, descf = JFeatureExtractor(jcam, JParams(over), max_kp=128).extract(
        *JS.render(jnp.asarray(np.asarray(JS.loop_trajectory(32))[0]), jcam))
    feats, descf = tuple(np.asarray(x) for x in fr), np.asarray(descf)
    key = jax.random.PRNGKey(7)
    port_check = EP.check_hypothesis

    def check(uv_a, uv_b, valid, generator=None, **kw):
        idx = torch.from_numpy(np.array(JR._sample_indices(key, jnp.asarray(valid.numpy()),
                                                            128, 8)))
        return port_check(uv_a, uv_b, valid, generator, indices=idx, **kw)

    monkeypatch.setattr(EP, "check_hypothesis", check)
    js, ts = _engines(over, 128)
    monkeypatch.setattr(js, "_split_key", lambda: key)
    out = []
    for slam, frame in ((js, _pair(feats)[0]), (ts, _pair(feats)[1])):
        a = slam.memory.create_signature(frame, np.eye(3, 4), 0.0)
        b = slam.memory.create_signature(frame, np.eye(3, 4), 1.0)
        a.descf, b.descf = descf, descf.copy()
        sts = [JStatistics() if slam is js else Statistics() for _ in range(2)]
        ok = slam._verify_hypothesis_ep(b, a.id, sts[0])
        b.descf = None
        ok_words = slam._verify_hypothesis_ep(b, a.id, sts[1])
        out.append((ok, ok_words, [(st.get("Loop/Epipolar pairs/"),
                                    st.get("Loop/Epipolar inliers/")) for st in sts]))
    assert out[1] == out[0]
    assert out[1][0] and out[1][2][0][0] == int(feats[3].sum())   # every valid keypoint
    assert ts.memory.py_matcher.calls == 1


def test_intermediate_nodes_match_the_jax_engine():
    poses = np.asarray(JS.loop_trajectory(48))[:9]
    grays, depths = JS.render_sequence(jnp.asarray(poses), JC.CameraModel.make(*CAM))
    feats = [_feats(grays[i], depths[i], 128) for i in range(len(poses))]
    over = {"Rtabmap/DetectionRate": 0.5, "Rtabmap/CreateIntermediateNodes": True,
            "Tpu/VocabularyCapacity": 8192}
    js, ts = _engines(over, 128)
    for i, pose in enumerate(poses):
        jf, tf = _pair(feats[i])
        a = js.process(jf, pose, stamp=float(i + 1))
        b = ts.process(tf, pose, stamp=float(i + 1))
        _same_tick(a, b, i)
        for key, v in a.data.items():
            if not key.startswith(("Timing", "TimingMem", "Memory/RAM")):
                np.testing.assert_allclose(b.get(key), v, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{i} {key}")
        assert _links(ts) == _links(js), i
        assert list(ts.memory.wm) == list(js.memory.wm)
        assert list(ts.memory.stm) == list(js.memory.stm)
    weights = {i: s.weight for i, s in js.memory.signatures.items()}
    assert {i: s.weight for i, s in ts.memory.signatures.items()} == weights
    assert sum(w < 0 for w in weights.values()) == 4
    jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
    assert sorted(jo) == sorted(to)
    for i in jo:
        np.testing.assert_allclose(to[i], np.asarray(jo[i]), atol=1e-3)

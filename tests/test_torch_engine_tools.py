"""The engine's maintenance and query API, the store reader and the store
tools: the port against the JAX package on the same map store.

The store: tests/test_maintenance_ops.py's scene (320x240 renders,
fx = fy = 300, of ``loop_trajectory(64)[:14]``, 384 keypoints, default
parameters, ground-truth odometry), mapped once by the port on the CPU and
closed. Both packages' engines then resume it (``Rtabmap.load``, no new
session), so they start from the same nodes, words, links and poses, and
run the same operations, the port given the JAX twin's RANSAC samples:
every ``compute_transform`` of the JAX engine draws from its next
``_split_key()``, and the port's k-th PnP-RANSAC draws the k-th key's
samples (``_sample_indices`` of the key, and of ``fold_in(key, 1)`` for
the 3-point half).

Tolerances and why: closure counts, link sets (endpoints and types), WM
and STM lists, weights and every id exactly (integer outputs); optimized
poses and link transforms within 1e-3 (float32 registrations and graph
solves sum in another order); the global bundle adjustment's poses within
1e-3 (float32 LM, the point blocks summed by ``index_add_``). The
``export_cloud --mesh --texture`` run is held to the JAX tool's output on
the same store: the faces exactly, vertices 1e-6 (1e-5 through the PLY's
five decimals), the atlas within one 8-bit level (texels within 1e-5
before the PNG's rounding).

The whole sequence of tests/test_maintenance_ops.py (more closures, a
registered user link, refining, the global BA) runs both engines' solves
and registrations dozens of times, about a minute on one CPU core, so it
is ``slow``; the quick gate holds a given user link, its rejection and the
getters.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.maps import mesh as JM
from rtabmap_tpu.maps import texture as JX
from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu.tools import cli as JCLI
from rtabmap_tpu.tools import export_poses as JE
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.core.frame import extract_features
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.memory.db_reader import DBReader, database_recovery
from rtabmap_tpu_torch.ops import ransac as PR
from rtabmap_tpu_torch.tools import cli as CLI
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = (300.0, 300.0, 160.0, 120.0, 320, 240)
CAM_ARG = ",".join(str(x) for x in CAM)
K = 384


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The port's map of the scene, closed into a store."""
    path = str(tmp_path_factory.mktemp("store") / "map.db")
    cam = C.CameraModel.make(*CAM)
    poses = S.loop_trajectory(64)[:14]
    db = Database(path)
    slam = Rtabmap(cam, Parameters(), db=db, node_capacity=64, words_per_frame=K, device="cpu")
    for i, pose in enumerate(poses):
        g, d = S.render(pose, cam, device="cpu")
        slam.process(extract_features(g, d, cam, K), pose, np.eye(6) * 1e-4,
                     stamp=float(i), raw=(g, d))
    slam.close()
    db.close()
    return path


def _engines(store, tmp_path, monkeypatch):
    """(JAX engine, port engine) resumed on copies of the store, the port
    drawing the JAX engine's RANSAC samples."""
    engines = []
    for name, E, D, P, kw in (("jax", JRtabmap, JDatabase, JParams, {}),
                              ("port", Rtabmap, Database, Parameters, {"device": "cpu"})):
        p = str(tmp_path / f"{name}.db")
        shutil.copyfile(store, p)
        engines.append(E.load(D(p), (JC if name == "jax" else C).CameraModel.make(*CAM), P(),
                              node_capacity=64, words_per_frame=K, new_session=False, **kw))
    js, ts = engines
    keys = []
    split = js._split_key

    def record():
        keys.append(split())
        return keys[-1]

    monkeypatch.setattr(js, "_split_key", record)
    used = []

    def jax_draws(generator, valid, iters, with_query_3d):
        key = keys[len(used)]
        used.append(key)
        v = jnp.asarray(valid.cpu().numpy())
        n = iters // 2
        return (torch.from_numpy(np.array(JR._sample_indices(key, v, n, 6))),
                torch.from_numpy(np.array(JR._sample_indices(jax.random.fold_in(key, 1), v,
                                                             iters - n, 3))))

    monkeypatch.setattr(PR, "pnp_sample_indices", jax_draws)
    return js, ts, keys, used


def _links(slam):
    return sorted((i, j, lk.type) for i, s in slam.memory.signatures.items()
                  for j, lk in s.links.items())


def _same_state(js, ts):
    assert _links(ts) == _links(js)
    assert ts.get_wm() == list(js.memory.wm) and ts.get_stm() == list(js.memory.stm)
    jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
    assert sorted(jo) == sorted(to)
    for k in jo:
        np.testing.assert_allclose(to[k], np.asarray(jo[k]), atol=1e-3, err_msg=str(k))


def _same_getters(js, ts, tmp_path):
    assert ts.get_wm_size() == js.get_wm_size() and ts.get_stm_size() == js.get_stm_size()
    assert ts.get_weights() == js.get_weights()
    assert ts.get_total_mem_size() == js.get_total_mem_size()
    assert ts.is_in_stm(14) == js.is_in_stm(14) and ts.is_in_stm(1) == js.is_in_stm(1)
    assert ts.get_loop_closure_id() == js.get_loop_closure_id()
    np.testing.assert_allclose(ts.get_map_correction(), js.get_map_correction(), atol=1e-3)
    for i in (1, 7, 14, 99):
        a, b = ts.get_pose(i), js.get_pose(i)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-3)
    (tp, tl), (jp, jl) = ts.get_graph(), js.get_graph()
    assert sorted(tp) == sorted(jp)
    assert (sorted((lk.from_id, lk.to_id, lk.type) for lk in tl)
            == sorted((lk.from_id, lk.to_id, lk.type) for lk in jl))
    sigs, poses, links = ts.get_3d_map()
    jsigs, jposes, jlinks = js.get_3d_map()
    assert sorted(sigs) == sorted(jsigs) and len(links) == len(jlinks)
    for i in poses:
        np.testing.assert_allclose(poses[i], jposes[i], atol=1e-3)
    copy, jcopy = ts.get_signature_copy(3, with_words=False), js.get_signature_copy(3,
                                                                                   with_words=False)
    assert copy.word_ids is None and copy.desc is None and copy.scan is None
    assert copy.links.keys() == jcopy.links.keys() and copy.links is not ts.memory.get(3).links
    np.testing.assert_array_equal(ts.get_signature_copy(3).word_ids,
                                  js.get_signature_copy(3).word_ids)
    assert ts.get_signature_copy(12345) is None and js.get_signature_copy(12345) is None
    assert ts.export_poses(str(tmp_path / "port.txt"), 1) == js.export_poses(
        str(tmp_path / "jax.txt"), 1)
    a, b = (JE.import_poses(str(tmp_path / f"{n}.txt"), 1) for n in ("port", "jax"))
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1e-3)


def test_user_link_reject_and_getters_match_the_jax_engine(store, tmp_path, monkeypatch):
    """A user link with its transform given, its rejection, and every
    getter, on both engines resumed on the store."""
    js, ts, keys, used = _engines(store, tmp_path, monkeypatch)
    _same_state(js, ts)
    _same_getters(js, ts, tmp_path)
    t_ab = np.asarray(T.np_relative(ts.get_pose(2), ts.get_pose(9)), np.float32)
    assert js.add_user_link(2, 9, t_ab) is True
    assert ts.add_user_link(2, 9, t_ab) is True
    _same_state(js, ts)
    assert ts.reject_last_loop_closure() == js.reject_last_loop_closure() is True
    _same_state(js, ts)
    _same_getters(js, ts, tmp_path)
    assert keys == used == []


@pytest.mark.slow
def test_maintenance_ops_match_the_jax_engine(store, tmp_path, monkeypatch):
    """tests/test_maintenance_ops.py's sequence of operations: more loop
    closures at 0.6 m, a registered user link, link refining, the undo of
    the last closure and the global bundle adjustment."""
    js, ts, keys, used = _engines(store, tmp_path, monkeypatch)
    added = js.detect_more_loop_closures(cluster_radius=0.6)
    assert ts.detect_more_loop_closures(cluster_radius=0.6) == added >= 1
    assert len(used) == len(keys) > 0
    _same_state(js, ts)
    assert js.add_user_link(1, 5) is True         # the JAX engine draws its key first
    assert ts.add_user_link(1, 5) is True
    _same_state(js, ts)
    refined = js.refine_links()
    assert ts.refine_links() == refined >= 5
    _same_state(js, ts)
    for i, s in ts.memory.signatures.items():
        for j, lk in s.links.items():
            np.testing.assert_allclose(lk.transform, js.memory.get(i).links[j].transform,
                                       atol=1e-3)
    assert ts.reject_last_loop_closure() == js.reject_last_loop_closure() is True
    _same_state(js, ts)
    assert js.global_bundle_adjustment(iters=8) is True
    assert ts.global_bundle_adjustment(iters=8) is True
    assert ts.global_ba_stats["path"] == "bundle_adjust"
    _same_state(js, ts)
    assert len(used) == len(keys)
    _same_getters(js, ts, tmp_path)


@pytest.mark.slow
def test_global_ba_with_rotations_off_so3_matches_the_jax_engine(store, tmp_path, monkeypatch):
    """Every third node's optimized rotation scaled 3% off SO(3) in both
    engines (a map's F2M odometry can leave rotations 7% off). The twin's
    problem, the rotations kept (``orthonormalize=False``), solved by the
    port's ``bundle_adjust``, gives the JAX engine's
    ``global_bundle_adjustment``; the port's own, the rotations projected
    onto SO(3), gives the JAX engine's run on the projected poses. Poses
    within 1e-3 (float32 LM, the point blocks summed by ``index_add_``)."""
    from rtabmap_tpu_torch.optim import ba as BA

    def off_so3(slam):
        for i in list(slam.optimized_poses):
            P = np.array(slam.optimized_poses[i], np.float32)
            if i % 3 == 0:
                P[:, :3] *= 1.03
            slam.optimized_poses[i] = P

    def project(slam):
        for i in list(slam.optimized_poses):
            P = np.asarray(slam.optimized_poses[i], np.float64)
            U, _, Vt = np.linalg.svd(P[:, :3])
            R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
            slam.optimized_poses[i] = np.concatenate([R, P[:, 3:]], 1).astype(np.float32)

    js, ts, _, _ = _engines(store, tmp_path, monkeypatch)
    off_so3(js)
    off_so3(ts)
    ids, _, prob = ts.global_ba_problem(orthonormalize=False)
    out, _ = BA.bundle_adjust(prob, iters=8, huber=4.0 / ts.cam.fx)
    assert js.global_bundle_adjustment(iters=8) is True
    for k, i in enumerate(ids):
        np.testing.assert_allclose(T.inverse(out.poses[k]).numpy(),
                                   np.asarray(js.optimized_poses[i]), atol=1e-3, err_msg=str(i))
    js, ts, _, _ = _engines(store, tmp_path, monkeypatch)
    off_so3(js)
    off_so3(ts)
    project(js)
    assert js.global_bundle_adjustment(iters=8) is True
    assert ts.global_bundle_adjustment(iters=8) is True
    assert ts.global_ba_stats["path"] == "bundle_adjust"
    _same_state(js, ts)


def test_reader_recovery_and_pose_tools(store, tmp_path):
    frames = list(DBReader(Database(store, async_writes=False), device="cpu"))
    jdb = JDatabase(store, async_writes=False)
    jframes = list(__import__("rtabmap_tpu.memory.db_reader", fromlist=["DBReader"])
                   .DBReader(jdb))
    assert len(frames) == len(jframes) == 14
    for (f, p, c, s), (jf, jp, jc, js_) in zip(frames, jframes):
        for a, b in zip(f, jf):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(p, jp)
        assert s == js_
    out = database_recovery(store, str(tmp_path / "rec.db"), device="cpu")
    from rtabmap_tpu.memory.db_reader import database_recovery as jrecovery
    jout = jrecovery(store, str(tmp_path / "jrec.db"))
    assert out == jout and out["nodes"] == 14
    rec = Database(str(tmp_path / "rec.db"), async_writes=False)
    jrec = JDatabase(str(tmp_path / "jrec.db"), async_writes=False)
    a, b = rec.load_admin()["optimized_poses"], jrec.load_admin()["optimized_poses"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-3)
    assert CLI.main(["info", store]) == JCLI.main(["info", store])
    for fmt in range(5):
        CLI.main(["export", store, str(tmp_path / f"p{fmt}.txt"), str(fmt)])
        JCLI.main(["export", store, str(tmp_path / f"j{fmt}.txt"), str(fmt)])
        a, b = (JE.import_poses(str(tmp_path / f"{n}{fmt}.txt"), fmt) for n in "pj")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5)
    assert (CLI.main(["reduce_graph", store, str(tmp_path / "r.db"), "3"])
            == JCLI.main(["reduce_graph", store, str(tmp_path / "jr.db"), "3"]))
    red, jred = (sorted((lk.from_id, lk.to_id, lk.type) for lk in D(p, async_writes=False)
                        .all_links()) for D, p in ((Database, str(tmp_path / "r.db")),
                                                   (JDatabase, str(tmp_path / "jr.db"))))
    assert red == jred
    for name in ("report", "calibration"):   # convert_model is ported (learned slice)
        with pytest.raises(NotImplementedError, match="slice"):
            CLI.main([name, store])
    # the dataset tools run: rgbd_dataset on a TUM layout, kitti_dataset on
    # a stereo layout into a store that Rtabmap.load resumes (stereo frames
    # store their image and no depth)
    from rtabmap_tpu_torch.datasets import layouts as L

    tum = str(tmp_path / "rgbd_dataset_freiburg2_synth")
    L.write_tum(tum, S.loop_trajectory(64)[:3], (160, 120), device="cpu")
    out = CLI.main(["rgbd_dataset", "--Rtabmap/DetectionRate", "0", tum, "--device", "cpu"])
    assert out["frames"] == 3 and out["lost"] == 0
    seq, gt = str(tmp_path / "seq"), str(tmp_path / "poses.txt")
    L.write_kitti(seq, gt, S.loop_trajectory(64)[:3], (160, 120), (80.0, 80.0, 79.5, 59.5),
                  0.3, device="cpu")
    db_path = str(tmp_path / "stereo.db")
    out = CLI.main(["kitti_dataset", "--Rtabmap/DetectionRate", "0", seq, gt, db_path,
                    "--device", "cpu"])
    assert out["frames"] == 3 and out["lost"] == 0 and "kitti_t_err_pct" not in out
    db = Database(db_path, async_writes=False)
    image, depth, _ = db.load_raw_frame(1)
    assert image is not None and depth is None
    resumed = Rtabmap.load(db, C.CameraModel.make(80.0, 80.0, 79.5, 59.5, 160, 120),
                           Parameters(), device="cpu")
    assert len(resumed.memory.signatures) == 3
    db.close()


def test_export_cloud_mesh_and_texture_match_the_jax_tool(tmp_path):
    """tests/test_texture.py's recorded store (three 32x24 frames of a
    plane at 1.5 m and a random texture) through both packages'
    export_cloud --mesh --texture, and as a plain mesh."""
    from rtabmap_tpu.geometry import transform as JT

    path = str(tmp_path / "rec.db")
    db = JDatabase(path, async_writes=False)
    tex = np.random.RandomState(1).rand(24, 32).astype(np.float32)
    for k in range(3):
        pose = np.asarray(JT.from_xyzrpy(np.array([0.05 * k, 0, 0, 0, 0, 0], np.float32)))
        db.save_raw_frame(k + 1, stamp=float(k), pose=pose, image=tex,
                          depth=np.full((24, 32), 1.5, np.float32))
    db.save_admin()
    db.flush()
    db.close()
    cam = ["--cam", "40,40,16,12,32,24", "--voxel", "0.1"]
    rec = CLI.main(["export_cloud", path, str(tmp_path / "port.obj"), "--mesh", "--texture",
                    "--device", "cpu", *cam])
    n = rec["faces"]
    jn = JCLI.main(["export_cloud", path, str(tmp_path / "jax.obj"), "--mesh", "--texture",
                    *cam])
    assert n == jn > 10
    v, f, uv, atlas = JX.read_textured_obj(str(tmp_path / "port.obj"))
    jv, jf, juv, jatlas = JX.read_textured_obj(str(tmp_path / "jax.obj"))
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-6)
    np.testing.assert_array_equal(uv, juv)
    assert np.abs(atlas.astype(int) - jatlas.astype(int)).max() <= 1
    assert rec["faces_observed"] > 0.5 * n and rec["mesh"].faces.shape[0] == n
    # the plain mesh: the same faces and vertices as the twin's textured OBJ
    assert CLI.main(["export_cloud", path, str(tmp_path / "port.ply"), "--mesh",
                     "--device", "cpu", *cam])["faces"] == jn
    pv, pf, _ = JM.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_allclose(pv, jv, atol=1e-5)

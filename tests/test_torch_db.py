"""The map store (``memory/db.py``): the port's twins of the round trips of
tests/test_db_resume.py, and stores opened across the two packages.

The store's format is the JAX package's, byte for byte (``np.save``
blobs compressed by zlib at level 1), so every comparison here is exact:
arrays with ``np.testing.assert_array_equal`` (same dtype and shape),
ids, links, counts and statistics with ``==``. A laser scan or a local
grid written by the JAX package passes through the port as its stored
blob and reads back in the JAX package equal to what it wrote. The
engine-level twins run the port alone on the CPU (no JAX engine, no jit):
4 and 14 ticks at 160x120 with 128 keypoints."""
import threading

import numpy as np
import pytest
import torch

from rtabmap_tpu.core.frame import EnvSensor as JEnvSensor
from rtabmap_tpu.core.laser_scan import LaserScan, ScanFormat
from rtabmap_tpu.maps.grids import LocalGrid
from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.memory.memory import Link as JLink
from rtabmap_tpu.memory.memory import Signature as JSignature
from rtabmap_tpu.vocab.dictionary import VWDictionary as JVWDictionary
from rtabmap_tpu_torch.core.frame import (
    ENV_SENSOR_AMBIENT_TEMPERATURE, ENV_SENSOR_WIFI_SIGNAL_STRENGTH, EnvSensor,
    FeatureExtractor,
)
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.memory.memory import Link, Signature
from rtabmap_tpu_torch.utils.params import Parameters
from rtabmap_tpu_torch.vocab.dictionary import VWDictionary
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
ARRAYS = ("pose", "word_ids", "desc", "uv", "pts3d", "valid3d", "gt_pose", "velocity", "gps",
          "global_desc")


def test_db_signature_roundtrip(tmp_path):
    path = str(tmp_path / "m.db")
    db = Database(path)
    sig = Signature(id=3, map_id=1, stamp=2.5, pose=np.eye(3, 4, dtype=np.float32), weight=7,
                    word_ids=np.array([1, 2, -1], np.int32), desc=np.ones((3, 256), np.int8),
                    uv=np.zeros((3, 2), np.float32), pts3d=np.ones((3, 3), np.float32),
                    valid3d=np.array([True, False, True]), label="kitchen")
    sig.links[4] = Link(3, 4, 0, np.eye(3, 4, dtype=np.float32), np.eye(6, dtype=np.float32))
    db.save_signature(sig)
    db.save_statistics(3, 2.5, {"Timing/Total/ms": 12.0})
    db.flush()
    db.close()

    db2 = Database(path)
    got = db2.load_signature(3)
    assert got.weight == 7 and got.map_id == 1 and got.label == "kitchen" and got.in_ltm
    np.testing.assert_array_equal(got.word_ids, sig.word_ids)
    assert 4 in got.links and got.links[4].type == 0
    assert db2.load_statistics()[0]["Timing/Total/ms"] == 12.0
    assert db2.load_signature(99) is None
    db2.close()


def test_user_data_roundtrip(tmp_path):
    path = str(tmp_path / "ud.db")
    db = Database(path, async_writes=False)
    sig = Signature(id=1, map_id=0, stamp=0.0, pose=np.eye(3, 4, dtype=np.float32))
    sig.user_data = b"wifi:-67dBm@00:11:22"
    db.save_signature(sig)
    db.close()
    db2 = Database(path, async_writes=False)
    assert db2.load_signature(1).user_data == b"wifi:-67dBm@00:11:22"
    db2.close()


def test_env_sensors_and_global_desc_roundtrip(tmp_path):
    path = str(tmp_path / "env.db")
    db = Database(path, async_writes=False)
    sig = Signature(id=2, map_id=0, stamp=1.0, pose=np.eye(3, 4, dtype=np.float32))
    sig.env_sensors = [EnvSensor(ENV_SENSOR_WIFI_SIGNAL_STRENGTH, -61.0, 1.0),
                       EnvSensor(ENV_SENSOR_AMBIENT_TEMPERATURE, 22.5, 1.0)]
    sig.global_desc = np.arange(128, dtype=np.float32)
    db.save_signature(sig)
    db.close()
    db2 = Database(path, async_writes=False)
    got = db2.load_signature(2)
    assert got.env_sensors == sig.env_sensors
    np.testing.assert_array_equal(got.global_desc, sig.global_desc)
    db2.close()


def test_admin_map_products_roundtrip(tmp_path):
    path = str(tmp_path / "prod.db")
    db = Database(path, async_writes=False)
    grid = np.random.RandomState(0).randint(-1, 101, (40, 50)).astype(np.int8)
    pts = np.random.RandomState(1).rand(100, 3).astype(np.float32)
    colors = (np.random.RandomState(2).rand(100, 3) * 255).astype(np.uint8)
    faces = np.arange(30, dtype=np.int32).reshape(10, 3)
    db.save_admin(params={"Grid/CellSize": "0.05"},
                  map2d=(grid, np.array([-1.0, -2.0], np.float32), 0.05),
                  opt_cloud=(pts, colors), opt_mesh=(pts[:30], faces))
    db.close()
    db2 = Database(path, async_writes=False)
    adm = db2.load_admin()
    np.testing.assert_array_equal(adm["map2d"]["grid"], grid)
    np.testing.assert_array_equal(adm["map2d"]["origin"], [-1.0, -2.0])
    assert float(adm["map2d"]["cell"]) == np.float32(0.05)
    np.testing.assert_array_equal(adm["opt_cloud"]["points"], pts)
    np.testing.assert_array_equal(adm["opt_cloud"]["colors"], colors)
    np.testing.assert_array_equal(adm["opt_mesh"]["faces"], faces)
    assert adm["parameters"] == {"Grid/CellSize": "0.05"}
    db2.save_admin(opt_cloud=(pts[:10],))        # a partial re-save keeps the rest
    adm2 = db2.load_admin()
    np.testing.assert_array_equal(adm2["map2d"]["grid"], grid)
    assert adm2["opt_cloud"]["points"].shape == (10, 3)
    db2.close()


def test_node_gt_velocity_gps_roundtrip(tmp_path):
    path = str(tmp_path / "gt.db")
    db = Database(path, async_writes=False)
    sig = Signature(id=5, map_id=0, stamp=3.0, pose=np.eye(3, 4, dtype=np.float32))
    sig.gt_pose = np.eye(3, 4, dtype=np.float32)
    sig.gt_pose[0, 3] = 1.25
    sig.velocity = np.array([0.1, 0, 0, 0, 0, 0.02], np.float32)
    sig.gps = np.array([3.0, -71.123456, 42.3654321, 12.0, 2.0, 0.0], np.float64)
    db.save_signature(sig)
    db.close()
    db2 = Database(path, async_writes=False)
    got = db2.load_signature(5)
    for name in ("gt_pose", "velocity", "gps"):
        np.testing.assert_array_equal(getattr(got, name), getattr(sig, name))
        assert getattr(got, name).dtype == getattr(sig, name).dtype
    db2.close()


def _frames(ways, n_loop=48):
    fe = FeatureExtractor(CAM, max_kp=128, device="cpu")
    poses = loop_trajectory(n_loop)
    return [(fe.extract(*render(poses[w], CAM, device="cpu"))[0], poses[w]) for w in ways]


def _engine(db, **kw):
    return Rtabmap(CAM, Parameters({"Tpu/VocabularyCapacity": 8192, **kw}), db=db,
                   node_capacity=32, words_per_frame=128, device="cpu")


def test_engine_persists_statistics_rows(tmp_path):
    """Every tick writes its statistics row, and with Mem/BinDataKept its
    raw frame."""
    path = str(tmp_path / "stats.db")
    db = Database(path)
    slam = _engine(db)
    fe = FeatureExtractor(CAM, max_kp=128, device="cpu")
    poses = loop_trajectory(8)
    raws = []
    for i in range(4):
        gray, depth = render(poses[i], CAM, device="cpu")
        raws.append((gray.numpy(), depth.numpy()))
        slam.process(fe.extract(gray, depth)[0], poses[i], stamp=float(i + 1), raw=(gray, depth),
                     extra_stats={"Odometry/TotalTime/ms": 7.5})
    slam.close()
    db.close()
    db2 = Database(path, async_writes=False)
    rows = db2.load_statistics()
    assert len(rows) == 4
    assert all("Timing/Total/ms" in r for r in rows)
    assert rows[0]["Odometry/TotalTime/ms"] == 7.5
    assert rows[-1]["Memory/Short time memory size/"] >= 1
    image, depth, _calib = db2.load_raw_frame(2)
    np.testing.assert_array_equal(image, raws[1][0])
    np.testing.assert_array_equal(depth, raws[1][1])
    db2.close()


def test_checkpoint_resume_multisession(tmp_path):
    """Map 8 frames, close, reopen, map 6 frames over the same stretch: the
    new session continues the ids, keeps the vocabulary and links to the
    old one; the store then holds one row per node and per directed link."""
    path = str(tmp_path / "map.db")
    frames = _frames(list(range(8)) + list(range(2, 8)))
    db = Database(path)
    slam = _engine(db)
    for i, (f, pose) in enumerate(frames[:8]):
        slam.process(f, pose, stamp=float(i + 1))
    n_words, n_nodes = slam.memory.vocab.n_words, len(slam.memory.signatures)
    opt = dict(slam.optimized_poses)
    slam.close()
    db.close()

    db2 = Database(path)
    slam2 = Rtabmap.load(db2, CAM, Parameters({"Tpu/VocabularyCapacity": 8192}),
                         node_capacity=32, words_per_frame=128, device="cpu")
    assert slam2.memory.vocab.n_words == n_words
    assert sorted(slam2.memory.wm) == sorted(opt) and len(slam2.memory.wm) == n_nodes
    assert slam2.memory.map_id == 1 and slam2.memory._next_id == n_nodes + 1
    for i, p in opt.items():
        np.testing.assert_array_equal(slam2.optimized_poses[i], p)
    for i, (f, pose) in enumerate(frames[8:]):
        slam2.process(f, pose, stamp=float(100 + i))
    sigs = slam2.memory.signatures
    assert any(sigs[j].map_id == 0 for i, s in sigs.items() if s.map_id == 1 for j in s.links
               if j in sigs), "sessions never linked"
    slam2.close()
    db2.close()
    db3 = Database(path, async_writes=False)
    assert len(db3.all_node_ids()) == len(sigs)
    assert len(db3.all_links()) == sum(len(s.links) for s in sigs.values())
    assert len(db3.load_statistics()) == 14
    db3.close()


def _jax_signatures():
    """Two sessions of signatures with every stored field, a laser scan
    and a local grid on the second, built with the JAX package's types."""
    rng = np.random.default_rng(5)
    sigs = []
    for sid in range(1, 6):
        s = JSignature(id=sid, map_id=int(sid > 3), stamp=float(sid), weight=sid % 3,
                       pose=rng.normal(size=(3, 4)).astype(np.float32),
                       word_ids=rng.integers(-1, 500, 16).astype(np.int32),
                       desc=(rng.integers(0, 2, (16, 256)) * 2 - 1).astype(np.int8),
                       uv=rng.random((16, 2)).astype(np.float32),
                       pts3d=rng.random((16, 3)).astype(np.float32),
                       valid3d=rng.random(16) > 0.3, label="door" if sid == 2 else "")
        s.gt_pose = rng.normal(size=(3, 4)).astype(np.float32)
        s.velocity = rng.normal(size=6).astype(np.float32)
        s.gps = rng.normal(size=6)
        s.user_data = bytes([sid]) * 3
        s.env_sensors = [JEnvSensor(1, -50.0 - sid, float(sid))]
        s.global_desc = rng.random(32).astype(np.float32)
        if sid > 1:
            s.links[sid - 1] = JLink(sid, sid - 1, 0, rng.normal(size=(3, 4)).astype(np.float32),
                                     np.eye(6, dtype=np.float32) * sid)
        sigs.append(s)
    sigs[1].scan = LaserScan(data=rng.random((50, 3)).astype(np.float32),
                             valid=rng.random(50) > 0.2, format=int(ScanFormat.XYZ),
                             max_range=12.5, local_transform=np.eye(3, 4, dtype=np.float32))
    sigs[2].grid = LocalGrid(ground=rng.random((8, 2)).astype(np.float32),
                             ground_valid=np.arange(8) < 5,
                             obstacles=rng.random((8, 2)).astype(np.float32),
                             obstacles_valid=np.arange(8) < 3,
                             empty=rng.random((8, 2)).astype(np.float32),
                             empty_valid=np.arange(8) < 8)
    return sigs


def _vocab_state(n_words=300, capacity=1024):
    rng = np.random.default_rng(9)
    slab = np.zeros((capacity, 256), np.int8)
    slab[:n_words] = rng.integers(0, 2, (n_words, 256)) * 2 - 1
    return {"slab": slab, "word_valid": np.arange(capacity) < n_words, "n_words": n_words,
            "nndr": 0.8, "incremental": True}


def _same_signature(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.id, a.map_id, a.weight, a.stamp, a.label, a.user_data) == \
        (b.id, b.map_id, b.weight, b.stamp, b.label, b.user_data)
    assert [tuple(e) for e in a.env_sensors] == [tuple(e) for e in b.env_sensors]
    assert sorted(a.links) == sorted(b.links)
    for j in a.links:
        la, lb = a.links[j], b.links[j]
        assert (la.from_id, la.to_id, la.type) == (lb.from_id, lb.to_id, lb.type)
        np.testing.assert_array_equal(la.transform, lb.transform)
        np.testing.assert_array_equal(la.information, lb.information)


def test_store_written_by_jax_opens_in_the_port(tmp_path):
    """Signatures, links, raw frames, statistics, the vocabulary and the
    optimized poses written by the JAX package read back equal in the
    port; re-saved by the port, the JAX package reads its laser scan and
    local grid back unchanged."""
    path, path2 = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    sigs = _jax_signatures()
    jdb = JDatabase(path, async_writes=False)
    for s in sigs:
        jdb.save_signature(s)
    image = np.random.default_rng(1).random((12, 16)).astype(np.float32)
    jdb.save_raw_frame(6, map_id=1, stamp=6.0, image=image, depth=image * 2)
    jdb.save_statistics(6, 6.0, {"Loop/Id/": 3.0})
    st = _vocab_state()
    opt = {s.id: s.pose * 2 for s in sigs}
    jdb.save_admin(params={"Mem/STMSize": 3}, optimized_poses=opt,
                   vocab=JVWDictionary.from_state(st))
    jdb.close()

    db = Database(path, async_writes=False)
    assert db.all_node_ids() == [1, 2, 3, 4, 5, 6]
    assert (db.max_node_id(), db.max_map_id()) == (6, 1)
    for s in sigs:
        got = db.load_signature(s.id)
        _same_signature(got, s)
        assert got.in_ltm
    assert isinstance(db.load_signature(2).scan, bytes)
    assert isinstance(db.load_signature(3).grid, bytes)
    im, dp, _ = db.load_raw_frame(6)
    np.testing.assert_array_equal(im, image)
    np.testing.assert_array_equal(dp, image * 2)
    assert db.load_statistics() == [{"id": 6, "stamp": 6.0, "Loop/Id/": 3.0}]
    adm = db.load_admin()
    assert adm["parameters"] == {"Mem/STMSize": 3}
    assert sorted(adm["optimized_poses"]) == sorted(opt)
    for i, p in opt.items():
        np.testing.assert_array_equal(adm["optimized_poses"][i], p)
    np.testing.assert_array_equal(adm["vocab"]["slab"], st["slab"][:300])
    assert (adm["vocab"]["n_words"], adm["vocab"]["capacity"]) == (300, 1024)
    db2 = Database(path2, async_writes=False)
    for s in sigs:
        db2.save_signature(db.load_signature(s.id))
    db.close()
    db2.close()

    jdb2 = JDatabase(path2, async_writes=False)
    scan = jdb2.load_signature(2).scan
    for name in ("data", "valid", "local_transform"):
        np.testing.assert_array_equal(getattr(scan, name), getattr(sigs[1].scan, name))
    assert (scan.format, scan.max_range) == (sigs[1].scan.format, sigs[1].scan.max_range)
    grid = jdb2.load_signature(3).grid
    for name in ("ground", "obstacles", "empty"):
        want = getattr(sigs[2].grid, name)[getattr(sigs[2].grid, name + "_valid")]
        np.testing.assert_array_equal(getattr(grid, name)[getattr(grid, name + "_valid")], want)
    jdb2.close()


def test_store_written_by_the_port_opens_in_jax(tmp_path):
    """The port's rows, vocabulary and optimized poses read back equal in
    the JAX package."""
    path = str(tmp_path / "port.db")
    sigs = _jax_signatures()[:4]
    port_sigs = []
    for s in sigs:
        p = Signature(id=s.id, map_id=s.map_id, stamp=s.stamp, pose=s.pose, weight=s.weight,
                      word_ids=s.word_ids, desc=s.desc, uv=s.uv, pts3d=s.pts3d,
                      valid3d=s.valid3d, label=s.label, user_data=s.user_data,
                      env_sensors=[EnvSensor(*e) for e in s.env_sensors],
                      global_desc=s.global_desc, gt_pose=s.gt_pose, velocity=s.velocity,
                      gps=s.gps)
        p.links = {j: Link(lk.from_id, lk.to_id, lk.type, lk.transform, lk.information)
                   for j, lk in s.links.items()}
        port_sigs.append(p)
    db = Database(path)
    for p in port_sigs:
        db.save_signature(p)
    db.save_statistics(4, 4.0, {"Timing/Total/ms": 9.0})
    st = _vocab_state(n_words=77)
    opt = {p.id: p.pose + 1 for p in port_sigs}
    db.save_admin(params={"RGBD/Enabled": True}, optimized_poses=opt,
                  vocab=VWDictionary.from_state(st, device="cpu"))
    db.close()

    jdb = JDatabase(path, async_writes=False)
    for p in port_sigs:
        _same_signature(jdb.load_signature(p.id), p)
    assert jdb.load_statistics() == [{"id": 4, "stamp": 4.0, "Timing/Total/ms": 9.0}]
    adm = jdb.load_admin()
    assert adm["parameters"] == {"RGBD/Enabled": True}
    for i, pose in opt.items():
        np.testing.assert_array_equal(adm["optimized_poses"][i], pose)
    np.testing.assert_array_equal(adm["vocab"]["slab"], st["slab"][:77])
    assert (adm["vocab"]["n_words"], adm["vocab"]["capacity"], adm["vocab"]["nndr"]) == \
        (77, 1024, 0.8)
    jdb.close()


def test_port_resumes_a_store_written_by_jax(tmp_path):
    """``Rtabmap.load`` on a JAX-written store: the vocabulary restored,
    the last session paged into WM slots (word lists on the slab, word
    counts rebuilt), the first session left as LTM records, ids and
    sessions continued, the optimized poses restored."""
    path = str(tmp_path / "jax.db")
    sigs = _jax_signatures()
    jdb = JDatabase(path, async_writes=False)
    for s in sigs:
        jdb.save_signature(s)
    st = _vocab_state(n_words=500)
    opt = {s.id: s.pose for s in sigs}
    jdb.save_admin(optimized_poses=opt, vocab=JVWDictionary.from_state(st))
    jdb.close()
    db = Database(path)
    slam = Rtabmap.load(db, CAM, Parameters({"Tpu/VocabularyCapacity": 1024}), node_capacity=16,
                        words_per_frame=16, device="cpu")
    mem = slam.memory
    assert mem.vocab.n_words == 500
    np.testing.assert_array_equal(mem.vocab.slab.numpy(), st["slab"])
    assert list(mem.wm) == [4, 5] and mem.map_id == 2 and mem._next_id == 6
    assert all(mem.get(i).in_ltm for i in (1, 2, 3))
    for i in (4, 5):
        np.testing.assert_array_equal(mem.node_words[mem.get(i).slot].numpy(), sigs[i - 1].word_ids)
    counts = np.zeros(1024, np.float32)
    for i in (4, 5):
        counts[np.unique(sigs[i - 1].word_ids[sigs[i - 1].word_ids >= 0])] += 1
    np.testing.assert_array_equal(mem.word_nw.numpy(), counts)
    for i, p in opt.items():
        np.testing.assert_array_equal(slam.optimized_poses[i], p)
    db.close()


def test_writer_refuses_an_unfinished_signature_and_reports_failures(tmp_path):
    """A signature whose deferred create is in flight is refused on the
    caller's thread; a write that fails on the writer thread is raised by
    the next flush."""
    db = Database(str(tmp_path / "w.db"))
    sig = Signature(id=1, map_id=0, stamp=0.0, pose=np.eye(3, 4, dtype=np.float32))
    sig.pending_word_ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="deferred create"):
        db.save_signature(sig)
    def disk_full():
        raise ValueError("disk full")

    db._submit(disk_full)
    with pytest.raises(RuntimeError, match="queued map-store write failed"):
        db.flush()
    with pytest.raises(RuntimeError):
        db.close()


def test_concurrent_writers_lose_no_row(tmp_path):
    """Eight threads saving signatures and statistics through the one
    writer thread, with flushes and reads in between, under a short
    switch interval: every row lands."""
    import sys

    db = Database(str(tmp_path / "c.db"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(25):
                sid = k * 100 + i + 1
                db.save_signature(Signature(id=sid, map_id=k, stamp=float(i),
                                            pose=np.eye(3, 4, dtype=np.float32)))
                db.save_statistics(sid, float(i), {"k": float(k)})
                if i % 10 == 0:
                    db.flush()
                    db.all_node_ids()

        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        db.flush()
        assert len(db.all_node_ids()) == 200 and len(db.load_statistics()) == 200
    finally:
        sys.setswitchinterval(old)
        db.close()

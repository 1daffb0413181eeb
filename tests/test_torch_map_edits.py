"""Labels, user data, the map edits and the dumps: the port against the
JAX package on the same store.

Both packages resume tests/test_torch_engine_tools.py's store (the port's
14-node map of ``loop_trajectory(64)[:14]`` at 320x240; the same module
fixture, so no JAX engine tick is paid for) without a new session and make
the same calls: virtual links and ``Memory.clear``, labels and user data
(each package's writes read back by the other's ``Database``),
``delete_last_location`` persisted, ``reset_memory``, and the dot,
prediction and log-file dumps.

Tolerances and why: link ends and types, labels, user data, node ids and
the dot text exactly (integer or text outputs of the same host code); the
prediction matrix within 1e-5 (both print six decimals of float64 sums);
the log files' float columns within 1e-5 (values read back from the same
stored statistics).
"""
import csv
import os

import numpy as np
import pytest

from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.utils.logging import Statistics as JStatistics
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.memory.memory import LINK_VIRTUAL_CLOSURE, Link
from rtabmap_tpu_torch.utils.logging import Statistics
from test_torch_engine_tools import store  # noqa: F401
from test_torch_planner import _engines, _links
from torch_port_threads import one_torch_thread  # noqa: F401


def test_virtual_links_and_clear_match_the_twin(store, tmp_path):  # noqa: F811
    js, ts = _engines(store, tmp_path)
    for slam in (js, ts):
        mem = slam.memory
        for a, b in ((3, 9), (3, 12), (5, 11)):
            mem.add_link(Link(a, b, LINK_VIRTUAL_CLOSURE, np.eye(3, 4, dtype=np.float32),
                              np.eye(6, dtype=np.float32) * 0.01))
    assert _links(ts) == _links(js) and len(_links(ts, LINK_VIRTUAL_CLOSURE)) == 6
    for slam in (js, ts):
        slam.memory.remove_virtual_links(3)
        slam.memory.remove_virtual_links(999)      # not a node
    assert _links(ts) == _links(js)
    assert _links(ts, LINK_VIRTUAL_CLOSURE) == [(5, 11, 5), (11, 5, 5)]
    map_id = ts.memory.map_id
    for slam in (js, ts):
        slam.memory.clear()
    assert ts.memory.map_id == js.memory.map_id == map_id + 1
    assert (len(ts.memory.signatures), list(ts.memory.wm), list(ts.memory.stm)) == \
        (len(js.memory.signatures), list(js.memory.wm), list(js.memory.stm)) == (0, [], [])
    assert ts.memory.n_resident == 0 and not ts.memory.host_wm.any()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_labels_and_user_data_are_read_back_by_the_other_package(store, tmp_path,  # noqa: F811
                                                                  writer):
    js, ts = _engines(store, tmp_path, tag=writer)
    slam = ts if writer == "port" else js
    assert slam.set_label(3, "kitchen") and not slam.set_label(12345, "x")
    slam.memory.move_to_ltm(5)
    assert slam.memory.get(5).in_ltm
    assert slam.set_user_data(5, b"GOAL:5") and slam.set_user_data(4, b"wm")
    slam.memory.db.flush()
    path = slam.memory.db.path
    mid = (JDatabase if writer == "port" else Database)(path, async_writes=False)
    assert mid.load_signature(5).user_data == b"GOAL:5"      # written through from LTM
    mid.close()
    slam.close()
    slam.memory.db.close()
    for D in (Database, JDatabase):
        db = D(path, async_writes=False)
        assert db.load_signature(3).label == "kitchen"
        assert db.load_signature(5).user_data == b"GOAL:5"
        assert db.load_signature(4).user_data == b"wm"
        assert db.load_signature(6).label == "" and db.load_signature(6).user_data is None
        db.close()


def test_delete_last_location_and_reset_memory_match_the_twin(store, tmp_path):  # noqa: F811
    js, ts = _engines(store, tmp_path)
    for slam in (js, ts):
        assert slam.set_goal(1)
        assert slam.delete_last_location()
    assert ts.get_last_location_id() == js.get_last_location_id() == 13
    assert _links(ts) == _links(js) and 14 not in ts.optimized_poses
    rows = []
    for slam, D in ((js, JDatabase), (ts, Database)):
        slam.close()
        slam.memory.db.close()
        db = D(slam.memory.db.path, async_writes=False)
        rows.append(([r["id"] for r in db.node_infos()],
                     sorted((lk.from_id, lk.to_id, lk.type) for lk in db.all_links())))
        db.close()
    assert rows[1] == rows[0] and 14 not in rows[1][0] and len(rows[1][0]) == 13
    js, ts = _engines(store, tmp_path, tag="reset")
    map_id = ts.memory.map_id
    for slam in (js, ts):
        assert slam.set_goal(1)
        slam.reset_memory()
    assert (ts.memory.map_id, ts.path_status, ts.get_path(), ts.get_wm(), ts.get_stm(),
            len(ts.memory.signatures), len(ts.optimized_poses), ts.loop_closure_id) == \
        (js.memory.map_id, js.path_status, js.get_path(), js.get_wm(), js.get_stm(),
         len(js.memory.signatures), len(js.optimized_poses), js.loop_closure_id)
    assert ts.memory.map_id == map_id + 1 and ts.get_wm() == [] and ts.path_status == 0
    assert not ts.delete_last_location() and not js.delete_last_location()


def test_dumps_match_the_twin(store, tmp_path):  # noqa: F811
    js, ts = _engines(store, tmp_path)
    assert ts.generate_dot_graph(str(tmp_path / "p.dot")) == \
        js.generate_dot_graph(str(tmp_path / "j.dot")) == 13
    assert (tmp_path / "p.dot").read_text() == (tmp_path / "j.dot").read_text()
    js.dump_prediction(str(tmp_path / "j.txt"))
    ts.dump_prediction(str(tmp_path / "p.txt"))
    a, b = np.loadtxt(tmp_path / "p.txt"), np.loadtxt(tmp_path / "j.txt")
    assert a.shape == b.shape == (65, 65) and a[:, :14].sum() > 0
    np.testing.assert_allclose(a, b, atol=1e-5)
    rows = Database(store, async_writes=False).load_statistics()
    assert len(rows) == 14
    for slam, S in ((js, JStatistics), (ts, Statistics)):
        for r in rows:
            st = S()
            for k, v in r.items():
                if k not in ("id", "stamp"):
                    st.add(k, v)
            st.ref_id, st.loop_closure_id = r["id"], int(r.get("Loop/Id/", 0))
            slam.stats_history.append(st)
    out = {}
    for name, slam in (("jax", js), ("port", ts)):
        os.makedirs(tmp_path / name)
        path_f = slam.write_log_files(str(tmp_path / name))
        assert path_f == str(tmp_path / name / "LogF.csv")
        out[name] = [list(csv.reader(open(tmp_path / name / f))) for f in ("LogF.csv",
                                                                         "LogI.csv")]
    for (pf, pi), (jf, ji) in [(out["port"], out["jax"])]:
        assert pi == ji and pf[0] == jf[0] and len(pf) == len(jf) == 15
        assert len(pi[0]) > 10 and len(pf[0]) > 10
        np.testing.assert_allclose(np.asarray(pf[1:], float), np.asarray(jf[1:], float),
                                   atol=1e-5)

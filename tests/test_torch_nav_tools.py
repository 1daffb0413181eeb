"""The optimizer factory, the store tool db_edit and profile traces: the
port against the JAX package.

``create_optimizer`` for ``Optimizer/Strategy`` 0-3; ``db_edit``'s
``nodes``, ``links``, ``set_label`` and ``dot`` against the JAX tool on
copies of one store (six nodes mapped by the port at 512 words a node,
the twin's edits' assumption), each tool's label read back by the other
package; ``profile_trace`` on the CPU: a ``run_dataset`` trace with one
range a frame, and nothing for an empty directory.

Tolerances and why: every listing, label and the dot text exactly (text
and integer outputs of the same host code).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.tools import cli as JCLI
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.tools import cli as CLI
from rtabmap_tpu_torch.utils.params import Parameters
from test_torch_engine_tools import CAM
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("strategy", range(4))
def test_create_optimizer_matches_the_twin(strategy):
    from rtabmap_tpu import optim as JO
    from rtabmap_tpu_torch import optim as O

    a = O.create_optimizer(strategy=strategy)
    b = JO.create_optimizer(strategy=strategy)
    assert a.__name__ == b.__name__ and a.__module__.startswith("rtabmap_tpu_torch.")
    assert O.create_optimizer(Parameters({"Optimizer/Strategy": strategy})).__name__ == \
        JO.create_optimizer(JParams({"Optimizer/Strategy": strategy})).__name__
    assert O.create_optimizer(strategy="pcg") is O.optimize_pcg


@pytest.fixture(scope="module")
def store512(tmp_path_factory):
    """Six nodes of the store's scene at 512 words a node: the twin's
    db_edit edits load the store with its default 512 words a node."""
    from rtabmap_tpu_torch.core.frame import extract_features
    from rtabmap_tpu_torch.datasets import synthetic as S

    path = str(tmp_path_factory.mktemp("store512") / "map.db")
    cam = C.CameraModel.make(*CAM)
    db = Database(path)
    slam = Rtabmap(cam, Parameters(), db=db, node_capacity=64, device="cpu")
    for i, pose in enumerate(S.loop_trajectory(64)[:6]):
        g, d = S.render(pose, cam, device="cpu")
        slam.process(extract_features(g, d, cam, 512), pose, np.eye(6) * 1e-4, stamp=float(i))
    slam.close()
    db.close()
    return path


def test_db_edit_matches_the_jax_tool(store512, tmp_path, capsys):
    paths = {}
    for name in ("port", "jax"):
        paths[name] = str(tmp_path / f"{name}.db")
        shutil.copyfile(store512, paths[name])
    run = {"port": lambda a: CLI.main(["db_edit", *a, "--device", "cpu"]),
           "jax": lambda a: JCLI.main(["db_edit", *a])}
    out = {n: run[n]([paths[n], "nodes"]) for n in run}
    assert out["port"] == out["jax"] and len(out["port"]) == 6
    links = {n: run[n]([paths[n], "links"]) for n in run}
    assert links["port"] == links["jax"] and len(links["port"]) >= 10
    assert run["port"]([paths["port"], "links", "0"]) == run["jax"]([paths["jax"], "links", "0"])
    assert run["port"]([paths["port"], "set_label", "2", "dock"]) is True
    assert run["jax"]([paths["jax"], "set_label", "2", "dock"]) is True
    for name, D in (("port", JDatabase), ("jax", Database)):      # read by the other
        db = D(paths[name], async_writes=False)
        assert db.load_signature(2).label == "dock"
        db.close()
    capsys.readouterr()
    listed = {n: run[n]([paths[n], "nodes"]) for n in run}
    assert listed["port"] == listed["jax"]
    assert json.loads(capsys.readouterr().out.split("\n]")[0] + "\n]") == listed["port"]
    assert [r["id"] for r in listed["port"] if r["label"]] == [2]
    assert run["port"]([paths["port"], "dot", str(tmp_path / "p.dot")]) == \
        run["jax"]([paths["jax"], "dot", str(tmp_path / "j.dot")])
    assert (tmp_path / "p.dot").read_text() == (tmp_path / "j.dot").read_text()
    cam = Database(paths["port"], async_writes=False).load_admin()["parameters"]["__camera__"]
    assert cam == list(CAM)            # the store's camera kept


def test_profile_trace_on_the_cpu(tmp_path):
    from rtabmap_tpu_torch.datasets import synthetic as S
    from rtabmap_tpu_torch.datasets.readers import Frame
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset
    from rtabmap_tpu_torch.utils.logging import profile_trace

    with profile_trace("") as off:
        with off.step(0):
            torch.ones(3).sum()
    assert off.path is None and off.wall_us == 0.0
    cam = C.CameraModel.make(80.0, 80.0, 79.5, 59.5, 160, 120)
    frames = [Frame(stamp=float(i), gray=g, depth=d, gt_pose=p)
              for i, p in enumerate(S.loop_trajectory(64)[:2])
              for g, d in [S.render(p, cam, device="cpu")]]
    trace_dir = tmp_path / "trace"
    out = run_dataset(frames, cam, Parameters({"Tpu/ProfileDir": str(trace_dir)}),
                      max_kp=128, node_capacity=16, verbose=False, device="cpu")
    tr = out["trace"]
    assert os.path.dirname(tr["path"]) == str(trace_dir) and tr["wall_ms"] > 0
    assert tr["device_busy_share"] == 0.0 and tr["device_ops"] == 0     # no card here
    events = json.load(open(tr["path"]))["traceEvents"]
    ticks = {e["name"] for e in events if str(e.get("name", "")).startswith("slam_tick#")}
    assert ticks == {"slam_tick#0", "slam_tick#1"}
    assert "trace" not in run_dataset(frames[:1], cam, Parameters(), max_kp=128,
                                      node_capacity=16, verbose=False, device="cpu")

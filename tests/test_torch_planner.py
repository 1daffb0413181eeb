"""The topological planner: the port against the JAX package on the same
inputs.

``compute_path`` runs on seeded random graphs (with unreachable goals and,
with integer lengths and no poses, many equal-cost ties). The engine-level
cases resume tests/test_torch_engine_tools.py's store (the port's 14-node
map of ``loop_trajectory(64)[:14]`` at 320x240; the same module fixture, so
no JAX engine tick is paid for) in both packages (``Rtabmap.load``, no new
session) and make the same calls on both: goals, the path getters and the
goal tracking. The map edits and dumps are in tests/test_torch_map_edits.py,
the optimizer factory, db_edit and the profile traces in
tests/test_torch_nav_tools.py (each file at most six quick tests: the
tier-1 run's scheduler queues the files with more ahead of
tests/test_sharded.py, its longest file).

Tolerances and why: path ids, statuses, path indices, stuck counts and
link ends and types exactly (integer outputs of the same host code); the
virtual links' and the goal transforms within 1e-5 (float32 compositions
in another order).

The slow case is the port's twin of tests/test_path_planning.py's
``test_goal_tracking_end_to_end`` through both engines on the same numpy
features (extracted once by the JAX package), ground-truth odometry and
the JAX engine's RANSAC samples injected into the port: the k-th key the
JAX engine splits off (``_split_key``) gives the port's k-th draw, one
registration's samples or, for a batch of pairs, each pair's from the
key's ``jax.random.split`` as the twin's batch kernel takes them.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.memory.db import Database as JDatabase
from rtabmap_tpu.utils import graph as JG
from rtabmap_tpu.utils.params import Parameters as JParams
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.memory.memory import LINK_VIRTUAL_CLOSURE
from rtabmap_tpu_torch.utils import graph as G
from rtabmap_tpu_torch.utils.params import Parameters
from test_torch_engine_tools import CAM, K, store  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

PLAN = {"RGBD/LocalRadius": 0.5, "RGBD/PlanStuckIterations": 2,
        "RGBD/GoalReachedRadius": 0.2}
CUR = 1000   # a node id off the path that stands for the robot's newest node


def _engines(store, tmp_path, over=None, tag=""):  # noqa: F811
    """(JAX engine, port engine) resumed on their own copies of the store."""
    out = []
    for name, E, D, P, cm, kw in (("jax", JRtabmap, JDatabase, JParams, JC, {}),
                                  ("port", Rtabmap, Database, Parameters, C,
                                   {"device": "cpu"})):
        p = str(tmp_path / f"{name}{tag}.db")
        shutil.copyfile(store, p)
        out.append(E.load(D(p), cm.CameraModel.make(*CAM), P(over or {}), node_capacity=64,
                          words_per_frame=K, new_session=False, **kw))
    return tuple(out)


def _links(slam, kind=None):
    return sorted((i, j, lk.type) for i, s in slam.memory.signatures.items()
                  for j, lk in s.links.items() if kind is None or lk.type == kind)


def _virtual(slam):
    return {(i, j): np.asarray(lk.transform) for i, s in slam.memory.signatures.items()
            for j, lk in s.links.items() if lk.type == LINK_VIRTUAL_CLOSURE}


def _same_plan(js, ts, what="", atol=1e-5):
    assert ts.path_status == js.path_status, what
    assert ts.get_path() == js.get_path(), what
    assert ts.get_path_current_goal() == js.get_path_current_goal(), what
    assert (ts._path_current_index, ts._path_goal_index, ts._path_stuck_count,
            ts._path_unreachable) == (js._path_current_index, js._path_goal_index,
                                      js._path_stuck_count, js._path_unreachable), what
    a, b = _virtual(ts), _virtual(js)
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=f"{what} {k}")
    np.testing.assert_allclose(ts._path_transform_to_goal,
                               np.asarray(js._path_transform_to_goal), atol=atol)
    for p, q in zip(ts.get_path_next_poses(), js.get_path_next_poses()):
        np.testing.assert_allclose(p, q, atol=atol)
    assert len(ts.get_path_next_poses()) == len(js.get_path_next_poses())


@pytest.mark.parametrize("seed", range(4))
def test_compute_path_matches_the_twin_on_random_graphs(seed):
    rng = np.random.default_rng(seed)
    n = 40
    ids = [int(i) for i in rng.permutation(np.arange(1, 200))[:n]]
    poses = {i: np.concatenate([np.eye(3), rng.uniform(-5, 5, (3, 1))], 1).astype(np.float32)
             for i in ids[: n - 5]}            # five nodes without a pose
    adj = {}
    for _ in range(70):
        a, b = (ids[k] for k in rng.choice(n - 3, 2, replace=False))  # three isolated ids
        w = float(rng.integers(1, 4)) if seed % 2 else float(rng.uniform(0.1, 3.0))
        adj.setdefault(a, {})[b] = w
        adj.setdefault(b, {})[a] = w
    pose_sets = (poses, {})                      # A*, and Dijkstra with its ties
    checked = unreachable = 0
    for P in pose_sets:
        for start in ids[:8]:
            for goal in ids:
                path = G.compute_path(P, adj, start, goal)
                assert path == JG.compute_path(P, adj, start, goal), (start, goal)
                checked += 1
                unreachable += not path
    assert checked == 2 * 8 * n and unreachable >= 2 * 8 * 3


def test_goals_and_path_getters_match_the_twin(store, tmp_path):  # noqa: F811
    js, ts = _engines(store, tmp_path, PLAN)
    _same_plan(js, ts, "idle")
    assert ts.compute_path(1) == js.compute_path(1) and len(ts.compute_path(1)) >= 10
    assert ts.compute_path(12345) == js.compute_path(12345) == []
    assert ts.set_goal(12345) is js.set_goal(12345) is False and ts.path_status == -1
    assert ts.set_goal(1) is js.set_goal(1) is True
    _same_plan(js, ts, "planned")
    assert ts.get_path()[0] == 14 and ts.get_path()[-1] == 1
    target = np.asarray(ts.optimized_poses[5], np.float32).copy()
    target[:3, 3] += np.asarray([0.05, -0.02, 0.03], np.float32)
    assert ts.set_goal_pose(target, 1.0) is js.set_goal_pose(target, 1.0) is True
    assert ts.get_path()[-1] == 5
    _same_plan(js, ts, "snapped")
    assert np.linalg.norm(ts._path_transform_to_goal[:3, 3]) > 1e-3
    far = target.copy()
    far[:3, 3] += 50.0
    assert ts.set_goal_pose(far) is js.set_goal_pose(far) is False   # RGBD/LocalRadius
    assert ts.path_status == js.path_status == -1
    assert ts.set_goal_pose(far, 0.0) is js.set_goal_pose(far, 0.0) is True   # unbounded
    _same_plan(js, ts, "unbounded")
    for slam in (js, ts):
        slam.clear_path(0)
    _same_plan(js, ts, "cleared")
    assert ts.get_path() == [] and ts.get_path_current_goal() == 0


def test_update_goal_index_matches_the_twin(store, tmp_path):  # noqa: F811
    """The newest node's optimized pose stepped along the path, with one
    path link removed (the tracker chains the path with virtual links),
    a stretch without progress (stuck: the sub-goal marked unreachable)
    and the goal reached (the path and its virtual links cleared)."""
    js, ts = _engines(store, tmp_path, PLAN)
    for slam in (js, ts):
        assert slam.set_goal(1)
        slam.memory.remove_link(8, 7)
        slam.memory.stm.append(CUR)
    path = ts.get_path()
    at = {i: np.asarray(ts.optimized_poses[i], np.float32) for i in path}
    steps = [14] * 7 + [13, 12, 11, 9, 8, 7, 5, 4, 2, 1]
    statuses = []
    for k, node in enumerate(steps):
        pose = at[node].copy()
        pose[:3, 3] += np.float32(0.01 * (k % 3))
        for slam in (js, ts):
            slam.optimized_poses[CUR] = pose
            slam.update_goal_index()
        _same_plan(js, ts, f"step {k} at node {node}")
        statuses.append((ts.path_status, ts._path_current_index, ts._path_goal_index,
                         ts._path_stuck_count, len(ts._path_unreachable), len(_virtual(ts))))
    assert statuses[-1][0] == 1 and not _virtual(ts)             # reached, links gone
    assert max(s[3] for s in statuses) >= 2 and max(s[4] for s in statuses) >= 1  # stuck
    assert max(s[5] for s in statuses) >= 2                       # a virtual chain
    assert ts.path_status == js.path_status == 1


def _inject_jax_draws(js, monkeypatch):
    """The port's PnP-RANSAC samples from the JAX engine's keys (see the
    module docstring); returns (keys split off, keys drawn from)."""
    from rtabmap_tpu.ops import ransac as JR
    from rtabmap_tpu_torch.ops import ransac as PR

    keys, used = [], []
    split = js._split_key

    def record():
        keys.append(split())
        return keys[-1]

    def draws(key, v, iters):
        n = iters // 2
        return (np.array(JR._sample_indices(key, v, n, 6)),
                np.array(JR._sample_indices(jax.random.fold_in(key, 1), v, iters - n, 3)))

    def jax_draws(generator, valid, iters, with_query_3d):
        key = keys[len(used)]
        used.append(key)
        v = jnp.asarray(valid.cpu().numpy())
        if v.ndim == 1:
            return tuple(torch.from_numpy(x) for x in draws(key, v, iters))
        per = [draws(k, v[p], iters) for p, k in enumerate(jax.random.split(key, v.shape[0]))]
        return tuple(torch.from_numpy(np.stack(x)) for x in zip(*per))

    monkeypatch.setattr(js, "_split_key", record)
    monkeypatch.setattr(PR, "pnp_sample_indices", jax_draws)
    return keys, used


@pytest.mark.slow
def test_goal_tracking_end_to_end_matches_the_jax_engine(monkeypatch):
    """tests/test_path_planning.py's goal tracking through both engines:
    16 mapped frames, a goal at the first node, a path link removed, then
    the recorded trajectory driven backwards until the goal is reached.
    The path, each tick's Planning/* values and the frame the goal is
    reached at are equal; poses, and the virtual links and path poses
    taken from them, within 1e-3 (float32 registrations and graph solves
    in another order)."""
    from rtabmap_tpu.core.frame import FrameFeatures as JFrame
    from rtabmap_tpu.core.frame import extract_features
    from rtabmap_tpu.datasets import synthetic as JS
    from rtabmap_tpu_torch.core.frame import FrameFeatures

    cam = (300.0, 300.0, 160.0, 120.0, 320, 240)
    jcam = JC.CameraModel.make(*cam)
    ex = jax.jit(lambda g, d: extract_features(g, d, jcam, 384))
    poses = np.asarray(JS.loop_trajectory(48))
    feats = {}

    def feat(i):
        if i not in feats:
            feats[i] = tuple(np.asarray(x) for x in ex(*JS.render(jnp.asarray(poses[i]), jcam)))
        return feats[i]

    over = {"RGBD/GoalReachedRadius": 0.4}
    js = JRtabmap(jcam, JParams(over), node_capacity=128, words_per_frame=384)
    ts = Rtabmap(C.CameraModel.make(*cam), Parameters(over), node_capacity=128,
                 words_per_frame=384, device="cpu")
    keys, drawn = _inject_jax_draws(js, monkeypatch)

    def tick(i, stamp):
        f = feat(i)
        a = js.process(JFrame(*(jnp.asarray(x) for x in f)), poses[i], np.eye(6) * 1e-4,
                       stamp=stamp)
        b = ts.process(FrameFeatures(*(torch.from_numpy(np.array(x)) for x in f)), poses[i],
                       np.eye(6) * 1e-4, stamp=stamp)
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
        assert _links(ts) == _links(js), i
        assert len(drawn) == len(keys), i
        return a, b

    used = [i for i in range(16) if tick(i, float(i))[1].ref_id]
    ids = sorted(ts.optimized_poses)
    assert ids == sorted(js.optimized_poses)
    assert ts.set_goal(ids[0]) is js.set_goal(ids[0]) is True
    path = ts.get_path()
    assert path == js.get_path() and path[0] == ids[-1] and path[-1] == ids[0]
    mid_a, mid_b = path[len(path) // 2], path[len(path) // 2 + 1]
    for slam in (js, ts):
        slam.memory.remove_link(mid_a, mid_b)
        slam.update_goal_index()
    _same_plan(js, ts, "restored", atol=1e-3)
    assert _virtual(ts)
    reached = None
    for k, i in enumerate(reversed(used[:-1])):
        a, b = tick(i, float(100 + k))
        for key in ("Planning/Current goal id/", "Planning/Path length/", "Planning/Status/",
                    "Loop/Reactivate id/"):
            assert b.get(key) == a.get(key), (k, key)
        assert set(b.data) == set(a.data), k
        jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
        for n in jo:
            np.testing.assert_allclose(to[n], np.asarray(jo[n]), atol=1e-3, err_msg=str(n))
        _same_plan(js, ts, f"drive {k}", atol=1e-3)
        if ts.path_status == 1:
            reached = k
            break
    assert reached is not None and js.path_status == 1 and len(drawn) >= 1
    for sid in path:
        s = ts.memory.get(sid)
        assert s is None or not any(lk.type == LINK_VIRTUAL_CLOSURE for lk in s.links.values())

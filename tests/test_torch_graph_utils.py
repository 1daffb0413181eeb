"""Pose-graph host utilities: the port's ``utils/graph.py`` against the JAX
twin on the same numpy poses and links. All outputs are ids, id pairs,
lists and distances computed the same way on the host, so they must be
equal exactly, order included."""
import numpy as np
import pytest

from rtabmap_tpu.utils import graph as JG
from rtabmap_tpu_torch.utils import graph as G


def _poses(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        a = rng.uniform(-np.pi, np.pi)
        P = np.zeros((3, 4), np.float32)
        P[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        P[:, 3] = rng.uniform(-3, 3, 3) * [1, 0.1, 1]
        out[int(rng.integers(1, 10_000))] = P
    return out


class _Sig:
    def __init__(self, links):
        self.links = links


class _Link:
    def __init__(self, f, t, d):
        self.from_id, self.to_id = f, t
        self.transform = np.eye(3, 4, dtype=np.float32)
        self.transform[:, 3] = [d, 0.5 * d, 0.0]


def test_adjacency_and_connected_component():
    sigs = {i: _Sig({}) for i in range(1, 9)}
    for a, b, d in ((1, 2, 1.0), (2, 3, 0.5), (3, 1, 2.0), (5, 6, 1.5), (6, 7, 0.2)):
        sigs[a].links[b] = _Link(a, b, d)
    adj, jadj = G.links_to_adjacency(sigs), JG.links_to_adjacency(sigs)
    assert adj == jadj
    for seed in (1, 5, 8):
        assert G.connected_component(adj, seed) == JG.connected_component(jadj, seed)


@pytest.mark.parametrize("radius,angle,k", [(0.0, 0.0, 0), (1.5, 0.0, 0), (2.0, 1.0, 5),
                                            (3.0, 0.3, 0)])
def test_nearest_nodes_and_filters(radius, angle, k):
    poses = _poses()
    target = next(iter(poses.values()))
    assert (G.find_nearest_nodes(target, poses, radius, angle, k)
            == JG.find_nearest_nodes(target, poses, radius, angle, k))
    if radius > 0:
        assert (G.radius_poses_filtering(poses, radius, angle)
                == JG.radius_poses_filtering(poses, radius, angle))
        assert (G.radius_poses_clustering(poses, radius, angle)
                == JG.radius_poses_clustering(poses, radius, angle))
    for neg in (False, True):
        assert (G.frustum_poses_filtering(poses, target, 60.0 + 20 * angle, 45.0, 0.1, 4.0, neg)
                == JG.frustum_poses_filtering(poses, target, 60.0 + 20 * angle, 45.0, 0.1, 4.0,
                                              neg))
    assert G.radius_poses_clustering({}, 1.0) == [] and G.frustum_poses_filtering({}, target) == []

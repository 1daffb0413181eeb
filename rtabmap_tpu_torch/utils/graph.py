"""Pose-graph host utilities: nearest nodes, radius and frustum filtering.

Port of ``rtabmap_tpu/utils/graph.py`` (the reference's ``graph``
namespace, Graph.cpp): ``compute_path`` (A* over the link topology),
``links_to_adjacency``, ``find_nearest_nodes``,
``radius_poses_filtering``, ``frustum_poses_filtering``,
``radius_poses_clustering``, ``connected_component`` and ``PoseStore``,
the optimized-pose map with a compact position array for radius queries.
Host-side numpy, as in the twin (graph bookkeeping is control-plane).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np


def compute_path(poses: Dict[int, np.ndarray], links: Dict[int, Dict[int, float]],
                 start: int, goal: int, updated_costs: bool = True) -> List[int]:
    """A* over ``links`` ({id: {neighbour: length}}) from ``start`` to
    ``goal``, with the Euclidean distance to the goal as the heuristic
    where both poses are known (else Dijkstra); the heap holds
    ``(cost, id)`` so equal costs pop the lower id first. Returns the node
    ids of the path, [] when the goal is unreachable (graph::computePath).
    ``updated_costs`` is accepted for the twin's signature and unused."""
    if start == goal:
        return [start]

    def h(n):
        if n in poses and goal in poses:
            return float(np.linalg.norm(poses[n][:3, 3] - poses[goal][:3, 3]))
        return 0.0

    dist = {start: 0.0}
    prev: Dict[int, int] = {}
    pq = [(h(start), start)]
    seen = set()
    while pq:
        _, u = heapq.heappop(pq)
        if u in seen:
            continue
        if u == goal:
            break
        seen.add(u)
        for v, w in links.get(u, {}).items():
            nd = dist[u] + w
            if v not in dist or nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd + h(v), v))
    if goal not in prev:
        return []
    path = [goal]
    while path[-1] != start:
        path.append(prev[path[-1]])
    return path[::-1]


def links_to_adjacency(signatures) -> Dict[int, Dict[int, float]]:
    """Build {id: {neighbor: length}} from signature link dicts."""
    adj: Dict[int, Dict[int, float]] = {}
    for sid, sig in signatures.items():
        for j, lk in sig.links.items():
            d = float(np.linalg.norm(np.asarray(lk.transform)[:3, 3]))
            adj.setdefault(sid, {})[j] = d
            adj.setdefault(j, {})[sid] = d
    return adj


def _angle_between(Ra: np.ndarray, Rb: np.ndarray) -> float:
    cosang = float(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))
    return float(np.arccos(cosang))


def find_nearest_nodes(target_pose: np.ndarray, poses: Dict[int, np.ndarray],
                       radius: float = 0.0, angle: float = 0.0,
                       k: int = 0) -> List[Tuple[int, float]]:
    """Nodes within ``radius`` (and a view-angle cone) of the target pose,
    nearest first (graph::findNearestNodes)."""
    tp = np.asarray(target_pose)
    out = []
    for i, P in poses.items():
        P = np.asarray(P)
        d = float(np.linalg.norm(P[:3, 3] - tp[:3, 3]))
        if radius > 0 and d > radius:
            continue
        if angle > 0 and _angle_between(P[:3, :3], tp[:3, :3]) > angle:
            continue
        out.append((i, d))
    out.sort(key=lambda x: x[1])
    return out[:k] if k > 0 else out


def radius_poses_filtering(poses: Dict[int, np.ndarray], radius: float,
                           angle: float = 0.0) -> List[int]:
    """One node per radius neighbourhood, in id order
    (graph::radiusPosesFiltering)."""
    kept: List[int] = []
    for i in sorted(poses):
        pi = np.asarray(poses[i])
        ok = True
        for j in kept:
            pj = np.asarray(poses[j])
            if np.linalg.norm(pi[:3, 3] - pj[:3, 3]) < radius:
                if angle <= 0 or _angle_between(pi[:3, :3], pj[:3, :3]) < angle:
                    ok = False
                    break
        if ok:
            kept.append(i)
    return kept


def frustum_poses_filtering(poses: Dict[int, np.ndarray], camera_pose: np.ndarray,
                            horizontal_fov_deg: float = 45.0,
                            vertical_fov_deg: float = 45.0,
                            near: float = 0.1, far: float = 100.0,
                            negative: bool = False) -> List[int]:
    """Poses whose position lies inside the camera's view frustum
    (graph::frustumPosesFiltering; its convention: camera X forward, Y up,
    Z right)."""
    cp = np.asarray(camera_pose, np.float32)
    ids = sorted(poses)
    if not ids:
        return []
    P = np.stack([np.asarray(poses[i], np.float32)[:3, 3] for i in ids])
    pc = (P - cp[:3, 3]) @ cp[:3, :3]          # R^T (p - t)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    th = np.tan(np.deg2rad(horizontal_fov_deg) / 2.0)
    tv = np.tan(np.deg2rad(vertical_fov_deg) / 2.0)
    inside = (x > near) & (x < far) & (np.abs(z) < x * th) & (np.abs(y) < x * tv)
    if negative:
        inside = ~inside
    return [i for i, ok in zip(ids, inside) if ok]


def radius_poses_clustering(poses: Dict[int, np.ndarray], radius: float,
                            angle: float = 0.0) -> List[Tuple[int, int]]:
    """Every ordered (id, neighbour id) pair within ``radius`` (and the
    orientation cone) of each other (graph::radiusPosesClustering)."""
    ids = sorted(poses)
    if not ids:
        return []
    P = np.stack([np.asarray(poses[i], np.float32) for i in ids])
    pos = P[:, :3, 3]
    near = np.sum((pos[:, None] - pos[None]) ** 2, axis=-1) < radius * radius
    np.fill_diagonal(near, False)
    if angle > 0:
        R = P[:, :3, :3]
        cosang = np.clip((np.einsum("iab,jab->ij", R, R) - 1.0) / 2.0, -1.0, 1.0)
        near &= np.arccos(cosang) < angle
    ii, jj = np.nonzero(near)
    return [(ids[a], ids[b]) for a, b in zip(ii, jj)]


def connected_component(adj: Dict[int, Dict[int, float]], seed: int) -> List[int]:
    out = {seed}
    frontier = [seed]
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, {}):
            if v not in out:
                out.add(v)
                frontier.append(v)
    return sorted(out)


class PoseStore(dict):
    """``Dict[id, (3,4) pose]`` with a compact (M,3) position array kept in
    sync so radius queries over tens of thousands of optimized poses are
    one vectorized numpy op instead of a Python scan (the role of the
    reference's graph::findNearestNodes KD-tree lookups in proximity
    detection — at 16k-64k WM the per-node Python loop dominated the
    engine tick)."""

    def __init__(self, *a, **kw):
        super().__init__()
        self._ids = np.zeros((256,), np.int64)
        self._xyz = np.zeros((256, 3), np.float32)
        self._row: Dict[int, int] = {}
        self._n = 0
        if a or kw:
            self.update(dict(*a, **kw))

    def __setitem__(self, i, pose):
        pose = np.asarray(pose, np.float32)
        super().__setitem__(i, pose)
        r = self._row.get(i)
        if r is None:
            if self._n == self._ids.shape[0]:
                self._ids = np.concatenate([self._ids, np.zeros_like(self._ids)])
                self._xyz = np.concatenate([self._xyz, np.zeros_like(self._xyz)])
            r = self._n
            self._n += 1
            self._row[i] = r
            self._ids[r] = i
        self._xyz[r] = pose[:3, 3]

    def __delitem__(self, i):
        super().__delitem__(i)
        r = self._row.pop(i)
        last = self._n - 1
        if r != last:  # swap-remove keeps the array compact
            li = int(self._ids[last])
            self._ids[r] = li
            self._xyz[r] = self._xyz[last]
            self._row[li] = r
        self._n = last

    def pop(self, i, *default):
        if i in self:
            v = self[i]
            del self[i]
            return v
        if default:
            return default[0]
        raise KeyError(i)

    def update(self, other=(), **kw):
        it = other.items() if hasattr(other, "items") else other
        for k, v in it:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def clear(self):
        super().clear()
        self._row.clear()
        self._n = 0

    def bulk_set(self, ids, poses) -> None:
        """Vectorized multi-pose write (the post-optimization sweep)."""
        poses = np.asarray(poses, np.float32)
        for k, i in enumerate(ids):
            self[i] = poses[k]

    def nearest_within(self, center_xyz, radius: float):
        """(ids, dists) of poses within ``radius`` of ``center_xyz``,
        nearest first — one vectorized distance over the compact array."""
        n = self._n
        if n == 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
        d = np.linalg.norm(
            self._xyz[:n] - np.asarray(center_xyz, np.float32)[None, :],
            axis=1)
        m = d < radius
        ids, dd = self._ids[:n][m], d[m]
        o = np.argsort(dd, kind="stable")
        return ids[o], dd[o]

"""Pose-graph host utilities.

Port of the part of ``rtabmap_tpu/utils/graph.py`` the engine reaches:
``PoseStore``, the optimized-pose map with a compact position array for
radius queries. Shortest paths, nearest-node and filtering helpers come
with the slices that call them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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

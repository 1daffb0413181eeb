"""Replay a map store as a sensor stream, and rebuild a damaged store.

Port of ``rtabmap_tpu/memory/db_reader.py`` (the reference's ``DBReader``
and ``databaseRecovery``): ``DBReader`` yields each stored node's features,
odometry pose, covariance and stamp as the engine's ``process`` takes them;
``database_recovery`` copies every readable node and link into a new store
and writes fresh optimized poses from one graph solve.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device, to_numpy


def signature_frame(sig, device: torch.device, valid=None) -> FrameFeatures:
    """A stored node's features as a ``FrameFeatures`` on ``device``; a
    keypoint is valid where ``valid`` says, by default where its descriptor
    is not all zero."""
    desc = np.asarray(sig.desc)
    n = len(sig.uv)
    if valid is None:
        valid = np.abs(desc.astype(np.int32)).sum(-1) > 0

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return FrameFeatures(
        uv=t(sig.uv, torch.float32), desc=t(desc, torch.int8), pts3d=t(sig.pts3d, torch.float32),
        valid=t(valid, torch.bool),
        valid3d=t(sig.valid3d, torch.bool), angle=torch.zeros(n, device=device),
        response=torch.zeros(n, device=device))


class DBReader:
    """Iterate a store's nodes in id order as (FrameFeatures, odometry
    pose (3,4), covariance (6,6), stamp); the features on ``device`` (None
    = the CUDA card)."""

    def __init__(self, db, ignore_odometry: bool = False, device: DeviceLike = None):
        self.db = db
        self.ignore_odometry = ignore_odometry
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Tuple[FrameFeatures, np.ndarray, np.ndarray, float]]:
        for sid in self.db.all_node_ids():
            sig = self.db.load_signature(sid)
            if sig is None or sig.word_ids is None:
                continue
            pose = np.eye(3, 4, dtype=np.float32) if self.ignore_odometry else sig.pose
            yield (signature_frame(sig, self.device), pose,
                   np.eye(6, dtype=np.float32) * 1e-4, sig.stamp)


def database_recovery(corrupt_path: str, out_path: str, device: DeviceLike = None) -> dict:
    """Rebuild a usable store from a possibly unclosed one (the reference's
    rtabmap-recovery): copy every readable node with its links, optimize
    the odometry chain and surviving links on ``device`` (None = the CUDA
    card), and write a fresh admin row. Returns the counts."""
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.optim import pose_graph as PG

    dev = resolve_device(device)
    src = Database(corrupt_path, async_writes=False)
    dst = Database(out_path, async_writes=False)
    n_nodes = n_links = 0
    ids = []
    for sid in src.all_node_ids():
        try:
            sig = src.load_signature(sid)
        except Exception:
            continue
        if sig is None or sig.pose is None:
            continue
        dst.save_signature(sig)
        ids.append(sid)
        n_nodes += 1
        n_links += len(sig.links)

    opt = {}
    if len(ids) >= 2:
        id_to_idx = {i: k for k, i in enumerate(ids)}
        poses, ef, et, meas, info = [], [], [], [], []
        for i in ids:
            sig = dst.load_signature(i)
            poses.append(sig.pose)
            for j, lk in sig.links.items():
                if j in id_to_idx and lk.from_id == i:
                    ef.append(id_to_idx[i])
                    et.append(id_to_idx[j])
                    meas.append(lk.transform)
                    info.append(lk.information if lk.information is not None
                                else np.eye(6, dtype=np.float32))
        if ef:
            g = PG.make_graph(np.stack(poses), np.asarray(ef), np.asarray(et), np.stack(meas),
                              np.stack(info), root=0, device=dev)
            out, _ = PG.optimize(g, iters=10)
            arr = to_numpy(out.poses)
            if np.isfinite(arr).all():
                opt = {i: arr[k] for k, i in enumerate(ids)}
        if not opt:
            opt = {i: np.asarray(dst.load_signature(i).pose) for i in ids}
    admin = {}
    try:
        admin = src.load_admin()
    except Exception:
        pass
    dst.save_admin(params=admin.get("parameters", {}), optimized_poses=opt)
    src.close()
    dst.close()
    return {"nodes": n_nodes, "links": n_links, "optimized": len(opt)}

"""3-D voxel occupancy (the OctoMap role) as a block-sparse log-odds slab.

Port of ``VoxelOccupancyMap`` from ``rtabmap_tpu/maps/voxel.py``: a
fixed-capacity device slab of 8x8x8 log-odds bricks with a host brick
table. Ray samples are computed on the device; collapsing duplicate
(voxel, kind) samples with occupied-endpoint priority and the brick table
stay on the host; the log-odds update is one scatter-add into the slab
on the device, done in place. The elevation map comes in a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import transform as T

BLOCK = 8
BLOCK_VOX = BLOCK * BLOCK * BLOCK


def _ray_samples(pose: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                 voxel: float, n_free: int, max_range: float):
    """World voxel coords of occupied endpoints and of the free-space ray
    samples -> (occ (K,3), free (K*n_free,3) int32, occ_ok, free_ok)."""
    world = T.apply(pose[None], pts[None])[0]
    origin = T.translation(pose)
    rng = torch.linalg.norm(world - origin[None], dim=-1)
    ok = valid & (rng > 1e-6) & (rng < max_range)
    # a tensor divisor: a host scalar would make the card multiply by its
    # reciprocal, which is not the division the JAX twin does
    vox = torch.tensor(voxel, dtype=torch.float32, device=pts.device)
    occ = torch.floor(world / vox).to(torch.int32)
    f = (torch.arange(n_free, dtype=torch.float32, device=pts.device) + 0.5) / (n_free + 1)
    free_pts = origin[None, None, :] + f[:, None, None] * (world - origin[None])[None]
    free = torch.floor(free_pts / vox).to(torch.int32).reshape(-1, 3)
    free_ok = ok[None].expand(n_free, ok.shape[0]).reshape(-1)
    return occ, free, ok, free_ok


class VoxelOccupancyMap:
    """Block-sparse 3-D log-odds occupancy over an unbounded volume."""

    OCC_INC = 0.85
    FREE_DEC = 0.7  # sigmoid(-0.7) = 0.33: free after a single clearing pass
    CLAMP = 4.0

    def __init__(self, voxel: float = 0.1, capacity_blocks: int = 4096,
                 n_free_samples: int = 12, max_range: float = 8.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.voxel = voxel
        self.cap = capacity_blocks
        self.n_free = n_free_samples
        self.max_range = max_range
        self.bricks = torch.zeros((capacity_blocks, BLOCK_VOX), dtype=torch.float32,
                                  device=self.device)
        self.colors = np.zeros((capacity_blocks, BLOCK_VOX, 3), np.uint8)
        self.table: Dict[Tuple[int, int, int], int] = {}
        self.cache: Dict[int, Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]] = {}
        self.poses: Dict[int, np.ndarray] = {}
        self.full = False

    # ------------------------------------------------------------ internals

    def _slots_for(self, block_keys: np.ndarray) -> np.ndarray:
        """Map (M,3) block coords -> slab slots, allocating as needed."""
        out = np.empty(block_keys.shape[0], np.int64)
        for i, k in enumerate(map(tuple, block_keys)):
            slot = self.table.get(k)
            if slot is None:
                if len(self.table) >= self.cap:
                    self.full = True
                    slot = -1
                else:
                    slot = len(self.table)
                    self.table[k] = slot
            out[i] = slot
        return out

    def _integrate(self, pose, pts, valid, colors=None):
        dev = self.device
        occ, free, occ_ok, free_ok = _ray_samples(
            torch.as_tensor(np.asarray(pose, np.float32), device=dev),
            torch.as_tensor(pts, dtype=torch.float32, device=dev),
            torch.as_tensor(valid, dtype=torch.bool, device=dev),
            self.voxel, self.n_free, self.max_range)
        occ_ok = occ_ok.cpu().numpy()
        occ = occ.cpu().numpy()[occ_ok]
        free = free.cpu().numpy()[free_ok.cpu().numpy()]
        if colors is not None:
            col = np.asarray(colors)[occ_ok]
        # collapse duplicates; occupied endpoints take priority over free.
        # Voxels are packed into int64 keys whose order is the (x, y, z)
        # lexicographic order of the JAX twin's np.unique(axis=0).
        occ_k, occ_first = np.unique(_pack(occ), return_index=True)
        free_k = np.unique(_pack(free))
        free_k = free_k[~np.isin(free_k, occ_k, assume_unique=True)]
        occ_u, free_u = _unpack(occ_k), _unpack(free_k)
        coords = np.concatenate([occ_u, free_u])
        delta = np.concatenate([np.full(len(occ_u), self.OCC_INC, np.float32),
                                np.full(len(free_u), -self.FREE_DEC, np.float32)])
        if coords.size == 0:
            return
        bk = np.floor_divide(coords, BLOCK)
        uniq_bk, inv = np.unique(_pack(bk), return_inverse=True)
        slots = self._slots_for(_unpack(uniq_bk))[inv.reshape(-1)]
        local = coords - bk * BLOCK
        lidx = (local[:, 0] * BLOCK + local[:, 1]) * BLOCK + local[:, 2]
        lin = slots * BLOCK_VOX + lidx
        mask = slots >= 0
        _scatter_logodds(self.bricks, torch.as_tensor(lin[mask], device=dev),
                         torch.as_tensor(delta[mask], device=dev), self.CLAMP)
        if colors is not None and len(occ_u):
            osl = slots[:len(occ_u)]
            oli = lin[:len(occ_u)] - osl * BLOCK_VOX
            m = osl >= 0
            self.colors[osl[m], oli[m]] = col[occ_first][m]

    # ------------------------------------------------------------------ API

    def update(self, node_id: int, pose, pts, valid, colors=None):
        """Integrate one node's cloud (sensor-frame points + node pose).
        Re-updating an existing node re-assembles the whole map."""
        reassemble = node_id in self.cache
        self.cache[node_id] = (_host(pts), _host(valid),
                               None if colors is None else np.asarray(colors))
        self.poses[node_id] = np.asarray(pose)
        if reassemble:
            self.assemble(self.poses)
        else:
            self._integrate(pose, pts, valid, colors)

    def assemble(self, poses: Dict[int, np.ndarray]):
        """Rebuild from the cached node clouds at new (optimized) poses."""
        self.bricks.zero_()
        self.colors[:] = 0
        self.table.clear()
        self.full = False
        for nid, pose in poses.items():
            if nid in self.cache:
                self.poses[nid] = np.asarray(pose)
                pts, valid, colors = self.cache[nid]
                self._integrate(pose, pts, valid, colors)

    def query(self, world_pts) -> np.ndarray:
        """Occupancy probability at world points (unknown -> 0.5)."""
        coords = np.floor(np.asarray(world_pts) / self.voxel).astype(np.int64)
        bk = np.floor_divide(coords, BLOCK)
        local = coords - bk * BLOCK
        lidx = (local[:, 0] * BLOCK + local[:, 1]) * BLOCK + local[:, 2]
        slots = np.array([self.table.get(tuple(k), -1) for k in bk])
        flat = self.bricks.cpu().numpy().reshape(-1)
        lo = np.where(slots >= 0, flat[np.clip(slots, 0, None) * BLOCK_VOX + lidx], 0.0)
        return 1.0 / (1.0 + np.exp(-lo))

    def occupied_voxels(self, thr: float = 0.65):
        """-> (centers (M,3) world meters, probs (M,), colors (M,3) u8)."""
        prob = 1.0 / (1.0 + np.exp(-self.bricks.cpu().numpy()))
        keys = np.zeros((self.cap, 3), np.int64)
        for k, s in self.table.items():
            keys[s] = k
        out_c, out_p, out_col = [], [], []
        occ = prob >= thr
        for s in range(len(self.table)):
            idx = np.nonzero(occ[s])[0]
            if idx.size == 0:
                continue
            lz = idx % BLOCK
            ly = (idx // BLOCK) % BLOCK
            lx = idx // (BLOCK * BLOCK)
            vox = keys[s] * BLOCK + np.stack([lx, ly, lz], axis=1)
            out_c.append((vox + 0.5) * self.voxel)
            out_p.append(prob[s][idx])
            out_col.append(self.colors[s][idx])
        if not out_c:
            return np.zeros((0, 3)), np.zeros((0,)), np.zeros((0, 3), np.uint8)
        return np.concatenate(out_c), np.concatenate(out_p), np.concatenate(out_col)


_KEY_BITS = 21
_KEY_OFF = 1 << (_KEY_BITS - 1)
_KEY_MASK = (1 << _KEY_BITS) - 1


def _pack(v: np.ndarray) -> np.ndarray:
    """(K,3) int voxel coords (|c| < 2**20) -> (K,) int64 keys, ordered as
    the rows are lexicographically."""
    v = v.astype(np.int64) + _KEY_OFF
    return (v[:, 0] << (2 * _KEY_BITS)) | (v[:, 1] << _KEY_BITS) | v[:, 2]


def _unpack(k: np.ndarray) -> np.ndarray:
    return np.stack([(k >> (2 * _KEY_BITS)) & _KEY_MASK, (k >> _KEY_BITS) & _KEY_MASK,
                     k & _KEY_MASK], axis=1) - _KEY_OFF


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scatter_logodds(bricks: torch.Tensor, lin_idx: torch.Tensor, delta: torch.Tensor,
                     clamp: float) -> None:
    """Add ``delta`` at the flat voxel indices (unique after the host
    collapse) and clamp the slab, in place."""
    flat = bricks.view(-1)
    flat.index_add_(0, lin_idx, delta)
    flat.clamp_(-clamp, clamp)

"""Synthetic scenes: a value-noise textured box room rendered analytically,
its loop trajectory, and a render-free landmark world for engine tests.

Port of ``World``, ``_hash2``/``value_noise``, ``render``,
``loop_trajectory`` and ``FeatureWorld`` from
``rtabmap_tpu/datasets/synthetic.py``. Camera convention: optical frame
(x right, y down, z forward), pose = camera-in-world (3,4).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T

_U32 = 0xFFFFFFFF


class World(NamedTuple):
    half_extent: Tuple[float, float, float]  # box half-sizes (walls at +-h)
    seed: int = 0


DEFAULT_WORLD = World(half_extent=(4.0, 3.0, 4.0), seed=0)


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """The JAX package's uint32 lattice hash -> [0,1]. uint32 wraparound is
    done in int64 with a 32-bit mask: every product of a masked value and
    a 31-bit constant stays below 2**63."""
    s = ((seed % (2 ** 31)) * 144665) & _U32
    h = ((ix.long() & _U32) * 374761393 + (iy.long() & _U32) * 668265263 + s) & _U32
    h = ((h ^ (h >> 13)) * 1274126177) & _U32
    return ((h ^ (h >> 16)) & 0xFFFF).float() / 65535.0


def value_noise(x: torch.Tensor, y: torch.Tensor, seed: int, octaves: int = 4,
                base_freq: float = 2.0) -> torch.Tensor:
    """Multi-octave bilinear value noise over continuous coords."""
    out = torch.zeros_like(x)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        f = base_freq * (2.0 ** o)
        xs, ys = x * f, y * f
        ix, iy = torch.floor(xs), torch.floor(ys)
        fx, fy = xs - ix, ys - iy
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        ixi, iyi = ix.long(), iy.long()
        s = seed * 7919 + o * 104729
        v00 = _hash2(ixi, iyi, s)
        v10 = _hash2(ixi + 1, iyi, s)
        v01 = _hash2(ixi, iyi + 1, s)
        v11 = _hash2(ixi + 1, iyi + 1, s)
        v = (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy
        out = out + amp * v
        total += amp
        amp *= 0.55
    return out / total


def render(pose_wc, cam: C.CameraModel, world: World = DEFAULT_WORLD,
           device: DeviceLike = None):
    """Render (gray (H,W) in [0,1], depth (H,W) meters, 0 = no hit) for a
    camera pose (3,4 camera-in-world)."""
    dev = resolve_device(device)
    pose = torch.as_tensor(np.array(pose_wc, np.float32), device=dev)
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                            torch.ones_like(uu)], dim=-1)
    Rwc = T.rotation(pose)
    origin = T.translation(pose)
    dirs = torch.einsum("ij,hwj->hwi", Rwc, dirs_cam)
    he = world.half_extent
    best_t = torch.full((H, W), float("inf"), device=dev)
    best_col = torch.zeros((H, W), device=dev)
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            denom = dirs[..., axis]
            denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
            t = (sgn * he[axis] - origin[axis]) / denom
            hit = origin[None, None, :] + t[..., None] * dirs
            a1, a2 = [i for i in range(3) if i != axis]
            inside = ((t > 0.05)
                      & (hit[..., a1].abs() <= he[a1] + 1e-4)
                      & (hit[..., a2].abs() <= he[a2] + 1e-4))
            tex = value_noise(hit[..., a1] * 0.5, hit[..., a2] * 0.5,
                              seed=world.seed * 31 + axis * 2 + (1 if sgn > 0 else 0))
            closer = inside & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best_col = torch.where(closer, tex, best_col)
    depth = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    return best_col, depth


def loop_trajectory(n: int, radius: float = 1.5, height: float = 0.0) -> np.ndarray:
    """Closed loop inside the room: the camera orbits the center looking
    outward. Returns (n,3,4) camera-in-world poses; frame 0 and frame n-1
    coincide in viewpoint."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        pos = np.array([radius * np.cos(a), height, radius * np.sin(a)], np.float32)
        fwd = pos / np.linalg.norm(pos)
        up = np.array([0.0, -1.0, 0.0], np.float32)  # y-down optical
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        Rcw = np.stack([right, upv, fwd], axis=1)
        poses.append(np.concatenate([Rcw, pos[:, None]], axis=1))
    return np.stack(poses).astype(np.float32)


class FeatureWorld:
    """Render-free landmark world for engine tests: a bank of features with
    fixed +-1 descriptors along a corridor; frame ``way`` sees the K
    features starting at bank index ``way * (K - overlap)``. Same bank and
    noise as the JAX package's ``FeatureWorld`` for the same seeds."""

    def __init__(self, cam: C.CameraModel, n_ways: int = 32, K: int = 128,
                 overlap: int = 64, desc_dim: int = 256, seed: int = 7,
                 step: float = 0.3, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cam, self.K, self.step = cam, K, step
        self.S = K - overlap
        r = np.random.RandomState(seed)
        n_feat = n_ways * self.S + K
        self.desc = np.where(r.rand(n_feat, desc_dim) > 0.5, 1, -1).astype(np.int8)
        self.pos = np.stack([
            step * np.arange(n_feat) / self.S + r.uniform(-0.1, 0.1, n_feat),
            r.uniform(-0.8, 0.8, n_feat),
            r.uniform(2.0, 4.0, n_feat),
        ], axis=1).astype(np.float32)

    def pose(self, way: int, nudge: float = 0.0) -> np.ndarray:
        p = np.eye(3, 4, dtype=np.float32)
        p[0, 3] = self.step * way + nudge
        return p

    def frame(self, way: int, noise_seed: int = 0, px_noise: float = 0.2):
        from rtabmap_tpu_torch.core.frame import FrameFeatures

        cam, K, dev = self.cam, self.K, self.device
        f0 = way * self.S
        idx = np.arange(f0, f0 + K)
        pts = self.pos[idx].copy()
        pts[:, 0] -= self.step * way
        rn = np.random.RandomState(100000 + noise_seed)
        uv = np.stack([pts[:, 0] / pts[:, 2] * np.float32(cam.fx) + np.float32(cam.cx),
                       pts[:, 1] / pts[:, 2] * np.float32(cam.fy) + np.float32(cam.cy)],
                      axis=1)
        uv = (uv + rn.randn(K, 2) * px_noise).astype(np.float32)
        ones = torch.ones((K,), dtype=torch.bool, device=dev)
        zeros = torch.zeros((K,), dtype=torch.float32, device=dev)
        return FrameFeatures(
            uv=torch.from_numpy(uv).to(dev), desc=torch.from_numpy(self.desc[idx]).to(dev),
            pts3d=torch.from_numpy(pts).to(dev), valid=ones, valid3d=ones,
            angle=zeros, response=zeros)

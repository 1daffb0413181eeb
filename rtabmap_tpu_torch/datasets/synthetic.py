"""Synthetic scenes: a value-noise textured box room rendered analytically,
its loop trajectory, and a render-free landmark world for engine tests.

Port of ``World``, ``_hash2``/``value_noise``, ``render``,
``render_sequence``, ``lidar_scan``, ``lidar_trajectory``,
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


def render_sequence(poses, cam: C.CameraModel, world: World = DEFAULT_WORLD,
                    depth_noise: float = 0.0, generator: torch.Generator = None,
                    device: DeviceLike = None):
    """Render a whole sequence -> (grays (N,H,W), depths (N,H,W)) on
    ``device``. With ``depth_noise`` > 0 and a ``generator``, each valid
    depth gets multiplicative Gaussian noise of that relative sigma (drawn
    from ``generator``, so not the JAX twin's draws)."""
    grays, depths = [], []
    for pose in np.asarray(poses):
        g, d = render(pose, cam, world, device=device)
        if depth_noise > 0.0 and generator is not None:
            noise = torch.randn(d.shape, generator=generator, device=d.device)
            d = torch.where(d > 0, d + depth_noise * d * noise, torch.zeros_like(d))
        grays.append(g)
        depths.append(d)
    return torch.stack(grays), torch.stack(depths)


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


# ----------------------------------------------------------------- lidar

# A Velodyne VLP-16 at its default 600 rpm: 16 rings over +-15 degrees of
# elevation, 1800 azimuth steps of 0.2 degrees, 10 scans a second (the
# sensor of the reference's examples/LidarMapping).
VLP16_RINGS = 16
VLP16_AZIMUTH = 1800
VLP16_ELEV_SPAN = float(np.radians(15.0))
VLP16_HZ = 10.0


def sensor_noise(rng: np.random.Generator, n_points: int, sigma: float) -> np.ndarray:
    """(n_points, 3) float32 range noise in the sensor frame, drawn from a
    seeded numpy generator, so that two implementations fed the same
    generator get the same noise."""
    return (sigma * rng.standard_normal((n_points, 3))).astype(np.float32)


def lidar_scan(pose_sw, n_azimuth: int = 360, n_rings: int = 8,
               room_half=(4.0, 3.0, 1.5), pillars=((1.5, 0.8, 0.4), (-2.0, -1.2, 0.5)),
               elev_span: float = 0.35, noise: float = 0.0,
               generator: torch.Generator = None, device: DeviceLike = None):
    """Analytic multi-ring 360-degree LiDAR in a box room with cylindrical
    pillars. Returns (N,3) points in the SENSOR frame and the validity
    mask, N = n_azimuth * n_rings, for ``pose_sw`` (3,4 sensor-in-world).
    The room is the box |x|<hx, |y|<hy, |z|<hz; pillars are vertical
    cylinders (cx, cy, r). ``noise`` > 0 adds world-frame Gaussian noise
    drawn from ``generator`` (a generator on the same device)."""
    dev = resolve_device(device)
    pose = torch.as_tensor(np.asarray(pose_sw, np.float32), device=dev)
    hx, hy, hz = room_half
    az = torch.arange(n_azimuth, dtype=torch.float32, device=dev) * np.float32(2.0 * np.pi / n_azimuth)
    el = torch.linspace(-elev_span, elev_span, n_rings, device=dev)
    azg, elg = torch.meshgrid(az, el, indexing="ij")
    d_s = torch.stack([torch.cos(elg) * torch.cos(azg),
                       torch.cos(elg) * torch.sin(azg),
                       torch.sin(elg)], dim=-1).reshape(-1, 3)
    R = pose[:, :3]
    o = pose[:, 3]
    d = d_s @ R.T

    # exit distance through the box (the sensor is inside): per-axis slab exit
    half = torch.tensor([hx, hy, hz], dtype=torch.float32, device=dev)
    safe = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t = ((torch.sign(safe) * half - o) / safe).min(dim=-1).values

    # cylinder pillars: |o_xy + t d_xy - c|^2 = r^2, nearest positive hit
    for (cx, cy, r) in pillars or ():
        oc = o[:2] - torch.tensor([cx, cy], dtype=torch.float32, device=dev)
        a = (d[:, :2] ** 2).sum(-1)
        b = 2.0 * (d[:, :2] @ oc)
        c = (oc ** 2).sum() - r * r
        disc = b * b - 4 * a * c
        hit = disc > 0
        tc = (-b - torch.sqrt(torch.where(hit, disc, torch.zeros_like(disc)))) / torch.clamp_min(2 * a, 1e-12)
        t = torch.where(hit & (tc > 0.05) & (tc < t), tc, t)

    pts_w = o[None] + t[:, None] * d
    if noise > 0.0:
        pts_w = pts_w + noise * torch.randn(pts_w.shape, generator=generator, device=dev)
    pts_s = (pts_w - o[None]) @ R
    valid = (t > 0.05) & torch.isfinite(t)
    return pts_s, valid


def lidar_trajectory(n: int, radius: float = 2.0) -> np.ndarray:
    """Closed planar loop for the LiDAR simulator: the sensor circles the
    room centre with its x axis tangent to the motion. Returns (n,3,4)
    float32 sensor-in-world poses."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        pos = np.array([radius * np.cos(a), radius * np.sin(a), 0.0], np.float32)
        fwd = np.array([-np.sin(a), np.cos(a), 0.0], np.float32)
        up = np.array([0.0, 0.0, 1.0], np.float32)
        left = np.cross(up, fwd)
        Rsw = np.stack([fwd, left, up], axis=1)
        poses.append(np.concatenate([Rsw, pos[:, None]], axis=1))
    return np.stack(poses).astype(np.float32)

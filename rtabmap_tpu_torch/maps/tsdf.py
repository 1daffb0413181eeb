"""TSDF volume fusion and surface-net mesh extraction.

Port of ``rtabmap_tpu/maps/tsdf.py`` (the export pipeline's offline
surface reconstruction): each depth frame updates the whole voxel grid in
one elementwise pass (KinectFusion's projective TSDF), and the mesh is the
zero crossing by naive surface nets, one vertex per sign-change cell and a
quad across each sign-change edge.

``surface_nets`` builds the quads of every edge at once on the device: the
twin loops over the edges in Python. The faces come out in the twin's
order (axes 0, 1, 2 in turn, edges in row-major order, two triangles a
quad), so vertices and faces equal the twin's on equal inputs.
``color_vertices`` colours each vertex from its most frontal keyframe.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T


class TSDFVolume:
    """Dense truncated signed-distance volume over an axis-aligned box, on
    ``device`` (None = the CUDA card)."""

    def __init__(self, origin, size_m, voxel: float = 0.02,
                 truncation: Optional[float] = None, max_weight: float = 64.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.origin = np.asarray(origin, np.float32)
        self.voxel = float(voxel)
        self.dims = tuple(int(np.ceil(s / voxel)) for s in np.asarray(size_m))
        self.trunc = float(truncation if truncation is not None else 4.0 * voxel)
        self.max_weight = float(max_weight)
        self.tsdf = torch.ones(self.dims, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(self.dims, dtype=torch.float32, device=self.device)

    def integrate(self, depth, pose, cam: C.CameraModel):
        """Fuse one depth frame taken at camera-in-world ``pose`` (3,4)."""
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight, _on(depth, self.device), _on(pose, self.device), cam,
            torch.from_numpy(self.origin).to(self.device), self.voxel, self.trunc,
            self.max_weight)

    def extract_mesh(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (vertices (V,3) world, faces (F,3) int32) by surface nets."""
        return surface_nets(self.tsdf, self.weight, self.origin, self.voxel)


def _on(a, device) -> torch.Tensor:
    """A host array or a tensor as float32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _integrate(tsdf, weight, depth, pose, cam: C.CameraModel, origin, voxel: float,
               trunc: float, max_weight: float):
    nx, ny, nz = tsdf.shape
    dev = tsdf.device
    gx, gy, gz = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=dev)
                                  for n in (nx, ny, nz)), indexing="ij")
    pts_w = (torch.stack([gx, gy, gz], dim=-1) + 0.5) * voxel + origin
    Tcw = T.inverse(pose)
    pc = torch.einsum("ij,...j->...i", T.rotation(Tcw), pts_w) + T.translation(Tcw)
    z = pc[..., 2]
    zs = torch.clamp_min(z, 1e-6)
    u = pc[..., 0] / zs * cam.fx + cam.cx
    v = pc[..., 1] / zs * cam.fy + cam.cy
    H, W = depth.shape
    # round half to even, as jnp.round; projections far off the image are
    # clipped here and masked below
    ui = torch.round(u).clamp(-1.0, float(W)).long().clamp(0, W - 1)
    vi = torch.round(v).clamp(-1.0, float(H)).long().clamp(0, H - 1)
    d = depth[vi, ui]
    in_img = (z > 1e-3) & (u >= 0) & (u < W) & (v >= 0) & (v < H) & (d > 1e-3)
    sdf = d - z
    upd = in_img & (sdf > -trunc)
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)
    w_new = upd.to(torch.float32)
    wsum = weight + w_new
    fused = torch.where(wsum > 0,
                        (tsdf * weight + tsdf_new * w_new) / torch.clamp_min(wsum, 1e-9), tsdf)
    return fused, torch.clamp_max(wsum, max_weight)


# the four cells around an edge along one axis, as (offset on the first
# other axis, offset on the second), in the twin's quad order
_QUAD = ((0, 0), (1, 0), (1, 1), (0, 1))


def surface_nets(tsdf: torch.Tensor, weight: torch.Tensor, origin, voxel: float,
                 min_weight: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive surface nets over the zero crossing, on the volume's device.

    Returns (vertices (V,3) float32 world coordinates, faces (F,3) int32,
    triangulated quads)."""
    dev = tsdf.device
    d = torch.where(weight >= min_weight, tsdf, torch.full_like(tsdf, float("nan")))
    corners = torch.stack([
        d[:-1, :-1, :-1], d[1:, :-1, :-1], d[:-1, 1:, :-1], d[1:, 1:, :-1],
        d[:-1, :-1, 1:], d[1:, :-1, 1:], d[:-1, 1:, 1:], d[1:, 1:, 1:]])
    all_known = ~torch.isnan(corners).any(dim=0)
    pos = (corners > 0).sum(dim=0)
    active = all_known & (pos > 0) & (pos < 8)
    idx = torch.nonzero(active)                              # (V,3), row-major
    if idx.shape[0] == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    vert_id = torch.full(active.shape, -1, dtype=torch.int64, device=dev)
    vert_id[idx[:, 0], idx[:, 1], idx[:, 2]] = torch.arange(idx.shape[0], device=dev)
    # the lattice cell centre, in float64 as the twin's numpy computes it
    org = torch.as_tensor(np.asarray(origin, np.float32), device=dev).double()
    verts = ((idx.double() + 1.0) * voxel + org).float()

    sign = d > 0
    known = ~torch.isnan(d)
    shape = torch.tensor(active.shape, device=dev)
    faces = []
    for axis in range(3):
        # an edge along `axis` between lattice points p and p + axis; its
        # four cells are p less one step on each of the two other axes
        sl_a = [slice(1, -1)] * 3
        sl_b = [slice(1, -1)] * 3
        sl_b[axis] = slice(2, None)
        sa = sign[tuple(sl_a)]
        cross = (sa != sign[tuple(sl_b)]) & known[tuple(sl_a)] & known[tuple(sl_b)]
        p = torch.nonzero(cross)                             # (E,3), row-major
        if p.shape[0] == 0:
            continue
        a2, a3 = [a for a in (0, 1, 2) if a != axis]
        cells = (p + 1)[:, None, :].repeat(1, 4, 1)          # (E,4,3)
        for k, (u_, v_) in enumerate(_QUAD):
            cells[:, k, a2] -= u_
            cells[:, k, a3] -= v_
        inb = ((cells >= 0) & (cells < shape)).all(dim=-1)
        c = torch.minimum(cells.clamp_min(0), shape - 1)
        vid = vert_id[c[..., 0], c[..., 1], c[..., 2]]
        ok = (inb & (vid >= 0)).all(dim=-1)
        quad = vid[ok]
        # orient by the sign of the field along the edge
        rev = sa[p[ok, 0], p[ok, 1], p[ok, 2]]
        quad = torch.where(rev[:, None], quad.flip(-1), quad)
        faces.append(torch.stack([quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]], dim=1).reshape(-1, 3))
    faces_t = (torch.cat(faces).to(torch.int32) if faces
               else torch.zeros((0, 3), dtype=torch.int32, device=dev))
    return verts, faces_t


def color_vertices(vertices: torch.Tensor, poses, grays, cam: C.CameraModel):
    """Per-vertex intensity from the most frontal observing keyframe (the
    first on ties). Returns (colours (V,), observed (V,) bool)."""
    dev = vertices.device
    V = vertices.shape[0]
    best = torch.full((V,), -1.0, dtype=torch.float32, device=dev)
    col = torch.zeros((V,), dtype=torch.float32, device=dev)
    for pose, gray in zip(poses, grays):
        Tcw = T.inverse(_on(pose, dev))
        pc = T.apply(Tcw[None], vertices[None])[0]
        z = pc[:, 2]
        u = pc[:, 0] / torch.clamp_min(z, 1e-6) * cam.fx + cam.cx
        v = pc[:, 1] / torch.clamp_min(z, 1e-6) * cam.fy + cam.cy
        g = _on(gray, dev)
        H, W = g.shape
        ok = (z > 1e-3) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        score = torch.where(ok, 1.0 / torch.clamp_min(z, 1e-3), torch.full_like(z, -1.0))
        take = score > best
        # truncation toward zero, as numpy's astype(int32)
        ui = u.clamp(-1.0, float(W)).trunc().long().clamp(0, W - 1)
        vi = v.clamp(-1.0, float(H)).trunc().long().clamp(0, H - 1)
        col = torch.where(take, g[vi, ui], col)
        best = torch.maximum(best, score)
    return col, best >= 0

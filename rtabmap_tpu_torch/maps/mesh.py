"""Surface reconstruction helpers: organized fast mesh, normals, gain
compensation and the PLY / OBJ files.

Port of ``rtabmap_tpu/maps/mesh.py`` (the reference's util3d_surface
``organizedFastMesh`` and ``GainCompensator``): the depth grid is
triangulated in one pass (two triangles a quad, masked by validity and
edge length), vertex normals are summed by ``index_add_`` (atomic on the
card, so equal to the twin up to summation order), and the gain solve is a
small dense least-squares on the host. The files are host I/O in the
twin's formats, so either package reads the other's.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import to_numpy
from rtabmap_tpu_torch.geometry import camera as C


def organized_fast_mesh(depth: torch.Tensor, cam: C.CameraModel, decimation: int = 2,
                        max_edge_ratio: float = 0.05, min_depth: float = 0.1,
                        max_depth: float = 20.0):
    """Triangulate an organized depth image on its device. Returns
    (vertices (H*W,3) camera frame, faces (M,3) int32, face_valid (M,)):
    faces touching invalid depth or a depth jump (|dz| > max_edge_ratio * z)
    are masked."""
    from rtabmap_tpu_torch.ops import cloud as CL

    d = depth[::decimation, ::decimation]
    H, W = d.shape
    pts, ok = CL.cloud_from_depth(depth, cam, decimation=decimation,
                                  min_depth=min_depth, max_depth=max_depth)
    idx = torch.arange(H * W, device=depth.device).reshape(H, W)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, :-1].reshape(-1)
    e = idx[1:, 1:].reshape(-1)
    z = d.reshape(-1)

    def edge_ok(i, j):
        zi, zj = z[i], z[j]
        return (zi - zj).abs() < max_edge_ratio * torch.maximum(zi, zj)

    okf = ok.reshape(-1)
    tri1_ok = okf[a] & okf[b] & okf[c] & edge_ok(a, b) & edge_ok(a, c) & edge_ok(b, c)
    tri2_ok = okf[b] & okf[c] & okf[e] & edge_ok(b, c) & edge_ok(b, e) & edge_ok(c, e)
    faces = torch.cat([torch.stack([a, c, b], -1), torch.stack([b, c, e], -1)]).to(torch.int32)
    return pts, faces, torch.cat([tri1_ok, tri2_ok])


def mesh_normals(vertices: torch.Tensor, faces: torch.Tensor,
                 face_valid: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals from the valid faces."""
    f = faces.long()
    v0, v1, v2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    fn = torch.where(face_valid[:, None], fn, torch.zeros_like(fn))
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn.index_add_(0, f[:, k], fn)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-12)


def compact_mesh(vertices, faces, face_valid, colors=None):
    """Drop the unused vertices and the invalid faces -> host (V, F[, C])."""
    vertices = to_numpy(vertices)
    faces = to_numpy(faces)[to_numpy(face_valid).astype(bool)]
    used = np.unique(faces)
    remap = np.full(len(vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    out_c = None if colors is None else to_numpy(colors)[used]
    return vertices[used], remap[faces], out_c


# ------------------------------------------------------------------- files


def write_ply(path: str, vertices, faces=None, colors=None, normals=None):
    """ASCII PLY (vertices, and optional normals, colours and faces)."""
    vertices = to_numpy(vertices)
    n = len(vertices)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        cols = [vertices] + ([to_numpy(normals)] if normals is not None else [])
        rows = np.concatenate(cols, axis=1)
        cc = None if colors is None else to_numpy(colors).astype(int)
        lines = []
        for i in range(n):
            line = " ".join(f"{v:.5f}" for v in rows[i])
            if cc is not None:
                line += f" {cc[i][0]} {cc[i][1]} {cc[i][2]}"
            lines.append(line + "\n")
        f.write("".join(lines))
        if faces is not None:
            f.write("".join(f"3 {t[0]} {t[1]} {t[2]}\n" for t in to_numpy(faces)))


def write_obj(path: str, vertices, faces):
    with open(path, "w") as f:
        f.write("".join(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n" for v in to_numpy(vertices)))
        f.write("".join(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n" for t in to_numpy(faces)))


def read_ply_counts(path: str) -> Tuple[int, int]:
    nv = nf = 0
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
            elif line.startswith("end_header"):
                break
    return nv, nf


def read_ply(path: str):
    """ASCII PLY import, the inverse of ``write_ply``. Returns (vertices
    (N,3), faces (M,3) or None, colours (N,3) uint8 or None)."""
    props: list = []
    nv = nf = 0
    with open(path) as f:
        in_vertex = False
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "element":
                in_vertex = t[1] == "vertex"
                if t[1] == "vertex":
                    nv = int(t[2])
                elif t[1] == "face":
                    nf = int(t[2])
            elif t[0] == "property" and in_vertex and t[1] != "list":
                props.append(t[2])
            elif t[0] == "end_header":
                break
        rows = [f.readline().split() for _ in range(nv)]
        faces = None
        if nf:
            faces = np.asarray([[int(x) for x in f.readline().split()[1:4]]
                                for _ in range(nf)], np.int32)
    arr = np.asarray(rows, np.float64)
    verts = arr[:, [props.index(c) for c in ("x", "y", "z")]].astype(np.float32)
    colors = None
    if "red" in props:
        colors = arr[:, [props.index(c) for c in ("red", "green", "blue")]].astype(np.uint8)
    return verts, faces, colors


# ------------------------------------------------------------ gain compensation


def gain_compensation(overlaps: List[Tuple[int, int, float, float]], n: int,
                      anchor: int = 0) -> np.ndarray:
    """Per-image exposure gains from pairwise overlap means (i, j, mean_i,
    mean_j): least squares on g_i m_i - g_j m_j with g_anchor = 1
    (GainCompensator's pairwise solve). Returns (n,) gains."""
    A = np.zeros((len(overlaps) + 1, n))
    b = np.zeros(len(overlaps) + 1)
    for k, (i, j, mi, mj) in enumerate(overlaps):
        A[k, i] = mi
        A[k, j] = -mj
    A[-1, anchor] = 1.0
    b[-1] = 1.0
    g, *_ = np.linalg.lstsq(A, b, rcond=None)
    return g

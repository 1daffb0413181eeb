"""Mesh texture mapping, two-band blending and the textured OBJ.

Port of ``rtabmap_tpu/maps/texture.py`` (the reference's
``createTextureMesh``, ``GainCompensator`` and multiband ``mergeTextures``):
every face gets a ``texel x texel`` block of a square atlas, sampled at
barycentric points; the low band is the visibility-weighted mean over all
cameras of the blurred images, the detail band the best camera's sharp
minus blurred image.

The twin bakes every camera at once and holds (Ncam, F * texel^2) arrays,
which at a map's size (hundreds of cameras, 10^5 faces) do not fit on one
card. Here the bake walks the cameras in chunks and touches only the
(camera, face) pairs with a positive score (a pair scoring 0 or less adds
nothing to either band): it keeps the running sums of w * low and of w,
and samples the best camera's sharp and low texels when that camera's
chunk comes. The result is the twin's up to summation order. The gain
step's pairwise overlap counts and means are products of the (Ncam, F)
masks on the device; ``gain_compensation`` stays a small host solve.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import to_numpy
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import image as IM

# texel samples a bake chunk may hold: at most 2^25 (camera, face, texel)
# samples, about 1.5 GB of float32 working arrays
_CHUNK_SAMPLES = 1 << 25


class TexturedMesh(NamedTuple):
    vertices: torch.Tensor     # (V, 3) world
    faces: torch.Tensor        # (F, 3) int32
    uvs: torch.Tensor          # (F, 3, 2) per-corner atlas UV in [0,1]
    atlas: torch.Tensor        # (A, A) or (A, A, 3) float32 in [0,1]
    face_camera: torch.Tensor  # (F,) int32 best camera, -1 = unobserved


def _face_grid(texel: int) -> np.ndarray:
    """Barycentric coordinates (texel^2, 3) of a texel x texel block: the
    face maps to the block corners (0,0), (1,0), (0,1); texels of the upper
    half are clamped onto the triangle, so the block has no empty seam."""
    u = (np.arange(texel, dtype=np.float32) + 0.5) / texel
    uu, vv = np.meshgrid(u, u, indexing="xy")
    b1, b2 = uu.reshape(-1), vv.reshape(-1)
    s = np.maximum(b1 + b2, 1.0)
    b1, b2 = b1 / s, b2 / s
    return np.stack([1.0 - b1 - b2, b1, b2], axis=-1)


def _stack(xs, device) -> torch.Tensor:
    """A list of (3,4) poses or images, or one stacked array, as a float32
    tensor on ``device``."""
    if isinstance(xs, torch.Tensor):
        return xs.to(device=device, dtype=torch.float32)
    return torch.stack([torch.from_numpy(np.array(x, np.float32)) if not
                        isinstance(x, torch.Tensor) else x.float().cpu()
                        for x in xs]).to(device)


def _cam_chunks(n_cam: int, per_cam: int):
    """Camera ranges whose samples (``per_cam`` each) fit a chunk."""
    step = max(1, min(n_cam, _CHUNK_SAMPLES // max(per_cam, 1)))
    return [(a, min(a + step, n_cam)) for a in range(0, n_cam, step)]


def face_camera_scores(vertices, faces, poses, cam: C.CameraModel, depths=None,
                       max_angle_deg: float = 85.0, depth_tol: float = 0.10) -> torch.Tensor:
    """Score each (camera, face) pair: cos(angle between the face normal
    and the view ray) / z^2 where the face centroid projects inside the
    image, lies in front of the camera, faces it, and (with ``depths``)
    passes the occlusion test |z - depth(u,v)| < depth_tol * z.
    Returns (Ncam, F); an unobservable pair gets -1. On the vertices'
    device."""
    verts = vertices.float()
    dev = verts.device
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    centroid = (v0 + v1 + v2) / 3.0
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)
    cos_max = float(np.cos(np.deg2rad(max_angle_deg)))
    W, H = int(cam.width), int(cam.height)
    pz = _stack(poses, dev)
    out = []
    for a, b in _cam_chunks(pz.shape[0], 4 * centroid.shape[0]):
        pose = pz[a:b]
        pc = T.apply(T.inverse(pose), centroid[None].expand(b - a, -1, -1))
        z = pc[..., 2]
        uv, _ = C.project(pc, cam)
        inb = C.in_image(uv, W, H, border=1.0) & (z > 1e-3)
        ray = centroid[None] - pose[:, None, :, 3]
        ray = ray / torch.clamp_min(torch.linalg.norm(ray, dim=-1, keepdim=True), 1e-9)
        # normals face the viewpoint that made the surface: a front-facing
        # face has n . ray < 0, and back faces are culled
        cosang = -(n[None] * ray).sum(-1)
        ok = inb & (cosang > cos_max)
        if depths is not None:
            dz = IM.bilinear_sample(_stack(depths[a:b], dev), uv, pad_value=0.0)
            ok = ok & ((dz <= 0) | ((dz - z).abs() < depth_tol * z))
        out.append(torch.where(ok, cosang / torch.clamp_min(z * z, 1e-6),
                               torch.full_like(z, -1.0)))
    return torch.cat(out)


def _sample_stack(stack: torch.Tensor, cam_idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample`` of image ``cam_idx[m]`` of ``stack`` (N,H,W[,ch])
    at ``uv`` (M,P,2), zero outside the image -> (M,P,ch)."""
    if stack.dim() == 3:
        stack = stack[..., None]
    N, H, W, ch = stack.shape
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    u0i, v0i = u0.long(), v0.long()
    flat = stack.reshape(N * H * W, ch)
    base = (cam_idx * (H * W))[:, None]

    def tap(vi, ui):
        val = flat[base + vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)]
        ok = ((vi >= 0) & (vi < H) & (ui >= 0) & (ui < W))[..., None]
        return torch.where(ok, val, torch.zeros_like(val))

    return (tap(v0i, u0i) * (1 - du) * (1 - dv)
            + tap(v0i, u0i + 1) * du * (1 - dv)
            + tap(v0i + 1, u0i) * (1 - du) * dv
            + tap(v0i + 1, u0i + 1) * du * dv)


def bake_face_atlas(vertices, faces, poses, cam: C.CameraModel, images, scores=None,
                    depths=None, texel: int = 8, gains=None, blur_sigma: float = 2.0,
                    multiband: bool = True) -> TexturedMesh:
    """Bake a per-face texel-block atlas with two-band blending, on the
    vertices' device. ``images``: (H,W) gray or (H,W,3) colour float
    images in [0,1], one a camera, or one stacked tensor."""
    verts = vertices.float()
    dev = verts.device
    f = faces.long()
    F = f.shape[0]
    if scores is None:
        scores = face_camera_scores(verts, faces, poses, cam, depths=depths)
    scores = scores.to(dev)
    best_cam = torch.argmax(scores, dim=0)              # the first best on ties
    observed = scores.max(dim=0).values > 0
    bary = torch.from_numpy(_face_grid(texel)).to(dev)  # (P2,3)
    P2 = bary.shape[0]
    pts = (bary[None, :, 0:1] * verts[f[:, 0]][:, None]
           + bary[None, :, 1:2] * verts[f[:, 1]][:, None]
           + bary[None, :, 2:3] * verts[f[:, 2]][:, None])       # (F,P2,3)
    imgs = _stack(images, dev)
    n_cam = imgs.shape[0]
    ch = 1 if imgs.dim() == 3 else imgs.shape[-1]
    g = (torch.as_tensor(np.asarray(gains, np.float32), device=dev) if gains is not None
         else torch.ones(n_cam, device=dev))
    blur = (IM.gaussian_blur(imgs, blur_sigma) if ch == 1 else
            IM.gaussian_blur(imgs.movedim(-1, 1), blur_sigma).movedim(1, -1))
    pz = _stack(poses, dev)
    Tcw = T.inverse(pz)
    w_face = torch.clamp_min(scores, 0.0)                # (Ncam,F)

    def sample(cams, fidx):
        """sharp, low (M,P2,ch) and in-image (M,P2) of faces ``fidx`` seen
        from cameras ``cams``."""
        pc = T.apply(Tcw[cams], pts[fidx])
        uv, _ = C.project(pc, cam)
        inb = (C.in_image(uv, int(cam.width), int(cam.height), border=1.0)
               & (pc[..., 2] > 1e-3))
        gain = g[cams][:, None, None]
        return (_sample_stack(imgs, cams, uv) * gain, _sample_stack(blur, cams, uv) * gain,
                inb)

    num = torch.zeros((F, P2, ch), device=dev)           # sum of w * low
    den = torch.zeros((F, P2), device=dev)               # sum of w
    best_sharp = torch.zeros((F, P2, ch), device=dev)
    best_low = torch.zeros((F, P2, ch), device=dev)
    pairs_per_cam = int((scores > 0).sum(dim=1).max()) * P2 if n_cam else 0
    for a, b in _cam_chunks(n_cam, pairs_per_cam):
        ci, fi = torch.nonzero(scores[a:b] > 0, as_tuple=True)
        ci = ci + a
        if ci.numel():
            _, low, inb = sample(ci, fi)
            w = w_face[ci, fi][:, None] * inb
            num.index_add_(0, fi, low * w[..., None])
            den.index_add_(0, fi, w)
        fb = torch.nonzero(observed & (best_cam >= a) & (best_cam < b), as_tuple=True)[0]
        if fb.numel():
            sharp, low, _ = sample(best_cam[fb], fb)
            best_sharp[fb] = sharp
            best_low[fb] = low
    low_blend = num / torch.clamp_min(den, 1e-9)[..., None]
    texelv = low_blend + (best_sharp - best_low) if multiband else best_sharp
    texelv = torch.clamp(texelv, 0.0, 1.0) * observed[:, None, None]

    # a square atlas of K x K blocks
    K = int(np.ceil(np.sqrt(F)))
    A = K * texel
    blocks = torch.cat([texelv.reshape(F, texel, texel, ch),
                        torch.zeros((K * K - F, texel, texel, ch), device=dev)])
    atlas = blocks.reshape(K, K, texel, texel, ch).permute(0, 2, 1, 3, 4).reshape(A, A, ch)
    if ch == 1:
        atlas = atlas[..., 0]
    # per-corner UVs: the block's triangle corners, inset half a texel
    fi = np.arange(F)
    corners = np.array([[0.5, 0.5], [texel - 0.5, 0.5], [0.5, texel - 0.5]], np.float32)
    uvs = (np.stack([(fi % K) * texel, (fi // K) * texel], axis=-1)[:, None, :]
           + corners[None]) / A
    face_camera = torch.where(observed, best_cam, torch.full_like(best_cam, -1))
    return TexturedMesh(verts, faces.to(torch.int32),
                        torch.from_numpy(uvs.astype(np.float32)).to(dev), atlas,
                        face_camera.to(torch.int32))


def _per_camera_face_means(centroids: torch.Tensor, poses, cam: C.CameraModel,
                           images) -> torch.Tensor:
    """Image intensity at each face centroid, per camera (Ncam, F): the
    gain solve's inputs."""
    dev = centroids.device
    imgs = _stack(images, dev)
    if imgs.dim() == 4:
        imgs = imgs.mean(dim=-1)
    pz = _stack(poses, dev)
    out = []
    for a, b in _cam_chunks(pz.shape[0], 4 * centroids.shape[0]):
        pc = T.apply(T.inverse(pz[a:b]), centroids[None].expand(b - a, -1, -1))
        uv, _ = C.project(pc, cam)
        out.append(IM.bilinear_sample(imgs[a:b], uv, pad_value=0.0))
    return torch.cat(out)


def texture_mesh(vertices, faces, poses, cam: C.CameraModel, images, depths=None,
                 texel: int = 8, compensate_gains: bool = True,
                 multiband: bool = True) -> TexturedMesh:
    """Camera assignment -> gain compensation -> two-band atlas bake, on
    the vertices' device."""
    from rtabmap_tpu_torch.maps.mesh import gain_compensation

    scores = face_camera_scores(vertices, faces, poses, cam, depths=depths)
    n = scores.shape[0]
    gains = None
    if compensate_gains and n > 1:
        bary = torch.from_numpy(_face_grid(4).mean(0)).to(vertices.device)
        cent = vertices.float()[faces.long()].transpose(1, 2) @ bary        # (F,3)
        means = _per_camera_face_means(cent, poses, cam, images).double()
        seen = (scores > 0).double()
        # over the faces both cameras see: the count, and each one's sum
        cnt = seen @ seen.T
        sums = (means * seen) @ seen.T             # sums[i, j]: camera i's
        cnt_h, sums_h = to_numpy(cnt), to_numpy(sums)
        overlaps = []
        for i, j in zip(*np.triu_indices(n, 1)):
            c = int(round(cnt_h[i, j]))
            if c >= 3:
                mi, mj = sums_h[i, j] / c, sums_h[j, i] / c
                if mi > 1e-6 and mj > 1e-6:
                    overlaps.append((int(i), int(j), float(mi), float(mj)))
        if overlaps:
            gains = gain_compensation(overlaps, n)
    return bake_face_atlas(vertices, faces, poses, cam, images, scores=scores,
                           depths=depths, texel=texel, gains=gains, multiband=multiband)


# ------------------------------------------------------------------ files

def write_png(path: str, img) -> None:
    """Minimal PNG encoder (stdlib zlib): 8-bit gray or RGB."""
    import struct
    import zlib

    a = to_numpy(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim == 2:
        color_type = 0
        a = a[..., None]
    else:
        color_type = 2
        if a.shape[-1] != 3:
            a = np.repeat(a[..., :1], 3, axis=-1)
    h, w = a.shape[:2]

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + a[r].tobytes() for r in range(h))
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for 8-bit gray or RGB files with filters 0-2."""
    import struct
    import zlib

    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, w, h, ctype = 8, b"", 0, 0, 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, _depth, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    nch = 3 if ctype == 2 else 1
    stride = w * nch
    rows = []
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        off = r * (stride + 1)
        filt = raw[off]
        row = np.frombuffer(raw[off + 1:off + 1 + stride], np.uint8).copy()
        if filt == 1:
            for i in range(nch, stride):
                row[i] = (int(row[i]) + int(row[i - nch])) & 0xFF
        elif filt == 2:
            row = ((row.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        elif filt != 0:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    a = np.stack(rows).reshape(h, w, nch)
    return a[..., 0] if nch == 1 else a


def write_textured_obj(path: str, mesh: TexturedMesh) -> None:
    """OBJ + MTL + atlas PNG (rtabmap-export --texture's files)."""
    import os

    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    write_png(base + ".png", mesh.atlas)
    with open(base + ".mtl", "w") as fp:
        fp.write(f"newmtl atlas\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.png\n")
    verts, faces, uvs = (to_numpy(x) for x in (mesh.vertices, mesh.faces, mesh.uvs))
    with open(path, "w") as fp:
        fp.write(f"mtllib {name}.mtl\nusemtl atlas\n")
        fp.write("".join(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts))
        fp.write("".join(f"vt {u:.6f} {1.0 - v:.6f}\n" for u, v in uvs.reshape(-1, 2)))
        fp.write("".join(f"f {t[0]+1}/{3*k+1} {t[1]+1}/{3*k+2} {t[2]+1}/{3*k+3}\n"
                         for k, t in enumerate(faces)))


def read_textured_obj(path: str):
    """Parse back (vertices, faces, uvs (F,3,2), atlas) as host arrays."""
    import os

    verts, uvs, faces, fuv = [], [], [], []
    with open(path) as fp:
        for line in fp:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vt":
                uvs.append([float(p[1]), 1.0 - float(p[2])])
            elif p[0] == "f":
                vi, ti = zip(*[(int(a.split("/")[0]) - 1, int(a.split("/")[1]) - 1)
                               for a in p[1:4]])
                faces.append(list(vi))
                fuv.append(list(ti))
    atlas = read_png(os.path.splitext(path)[0] + ".png")
    uvs = np.asarray(uvs, np.float32)
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            uvs[np.asarray(fuv, np.int32)], atlas)

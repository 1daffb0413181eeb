"""A minimal PNG codec on zlib and numpy, for the dataset readers.

Reads and writes the images the dataset layouts hold: 8-bit gray, 8-bit
RGB and 16-bit gray (big-endian samples), non-interlaced, every row
filter (None, Sub, Up, Average, Paeth). Any other PNG raises
``ValueError`` naming what it holds; a file that is not a PNG raises
``ValueError`` naming its format. ``to_gray8`` converts as PIL's
``convert("L")`` does.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> (channels, numpy sample dtype)
_FORMATS = {(0, 8): (1, np.dtype(np.uint8)), (2, 8): (3, np.dtype(np.uint8)),
            (0, 16): (1, np.dtype(">u2"))}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "RIFF/WebP"))


def _format_name(head: bytes) -> str:
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return "an unknown format"


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one row's filter (uint8 bytes; ``prev`` the decoded row above)."""
    if ftype == 0:
        return row
    if ftype == 1:      # Sub: a running sum along the row, per byte of a pixel
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:      # Up
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} is not a PNG filter type")
    # Average and Paeth need the decoded left byte: sequential along the row
    out = bytearray(len(row))
    f, b = row.tolist(), prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (a + b[i]) >> 1
        else:
            c = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b[i] if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H,W) uint8, (H,W,3) uint8 or (H,W) uint16."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: {_format_name(data[:8])} image, not a PNG; "
                         "the readers decode PNG only")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _comp, _filt, interlace = hdr
    if (ctype, depth) not in _FORMATS:
        raise ValueError(f"{path}: PNG color type {ctype} at {depth} bits is not read; "
                         "8-bit gray, 8-bit RGB and 16-bit gray are")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    channels, dtype = _FORMATS[(ctype, depth)]
    bpp = channels * dtype.itemsize
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {H * (stride + 1)}")
    rows = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        prev = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prev, bpp)
    img = out.view(dtype).reshape(H, W, channels) if channels > 1 else out.view(dtype)
    return img.astype(dtype.newbyteorder("=")) if dtype.itemsize > 1 else img


def _filter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    x = row.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1}.get(ftype)
    if ftype == 4:
        pred = _paeth(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0, level: int = 6):
    """Encode (H,W) uint8, (H,W,3) uint8 or (H,W) uint16 as a PNG with
    every row filtered by ``filter_type`` (0-4)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, bpp, samples = 0, 8, 1, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, bpp, samples = 2, 8, 3, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, bpp, samples = 0, 16, 2, img.astype(">u2")
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape} as PNG")
    H, W = img.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(H, W * bpp)
    out = np.empty((H, W * bpp + 1), np.uint8)
    out[:, 0] = filter_type
    if filter_type == 0:
        out[:, 1:] = rows
    else:
        prev = np.zeros(W * bpp, np.uint8)
        for r in range(H):
            out[r, 1:] = _filter_row(filter_type, rows[r], prev, bpp)
            prev = rows[r]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(out.tobytes(), level)) + chunk(b"IEND", b""))


def to_gray8(img: np.ndarray) -> np.ndarray:
    """(H,W) uint8 gray as PIL's ``convert("L")`` makes it: RGB by
    (R*19595 + G*38470 + B*7471 + 0x8000) >> 16, 16-bit gray clipped to 255."""
    if img.ndim == 3:
        rgb = img.astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    if img.dtype == np.uint16:
        return np.minimum(img, 255).astype(np.uint8)
    return img

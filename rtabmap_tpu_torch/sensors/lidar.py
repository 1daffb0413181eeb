"""Velodyne VLP-16 packets -> LaserScan.

Port of ``rtabmap_tpu/sensors/lidar.py`` (the reference's ``LidarVLP16``:
UDP data packets, per-firing azimuth interpolation, accumulation into
full-revolution scans). The byte-level parse is vectorized numpy on the
host, byte for byte the JAX twin's (a packet encoded by either package is
the same 1206 bytes); the polar -> cartesian conversion of a revolution
runs on the scan's device. The packet source is any iterable of raw
bytes, so tests and replays feed synthetic packets; ``udp_packets`` is a
plain socket loop for live capture.
"""
from __future__ import annotations

import socket
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.laser_scan import LaserScan, ScanFormat, make_scan
from rtabmap_tpu_torch.device import DeviceLike, resolve_device

PACKET_SIZE = 1206
BLOCKS_PER_PACKET = 12
CHANNELS_PER_BLOCK = 32
DISTANCE_RESOLUTION = 0.002  # 2 mm
# VLP-16 laser elevation angles (degrees), firing order
ELEVATIONS_DEG = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15], np.float32)


def encode_packet(azimuths_deg, distances_m, intensities=None) -> bytes:
    """A 1206-byte VLP-16 data packet (single-return mode), the test and
    replay counterpart of ``decode_packet``: azimuths (12,) degrees,
    distances (12, 32) metres, intensities (12, 32)."""
    buf = bytearray(PACKET_SIZE)
    d = (np.asarray(distances_m) / DISTANCE_RESOLUTION).astype(np.uint16)
    inten = (np.zeros((12, 32), np.uint8) if intensities is None
             else np.asarray(intensities).astype(np.uint8))
    for b in range(BLOCKS_PER_PACKET):
        off = b * 100
        buf[off:off + 2] = b"\xff\xee"  # block flag
        az = int(round(float(azimuths_deg[b]) * 100)) % 36000
        buf[off + 2:off + 4] = az.to_bytes(2, "little")
        for c in range(CHANNELS_PER_BLOCK):
            o = off + 4 + c * 3
            buf[o:o + 2] = int(d[b, c]).to_bytes(2, "little")
            buf[o + 2] = int(inten[b, c])
    # 4-byte timestamp (us) + 2-byte factory field
    buf[1200:1204] = (0).to_bytes(4, "little")
    buf[1204] = 0x37  # strongest return
    buf[1205] = 0x22  # VLP-16 product id
    return bytes(buf)


def decode_packet(pkt: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """1206-byte packet -> (azimuths_deg (12,), distances_m (12,32),
    intensities (12,32))."""
    if len(pkt) != PACKET_SIZE:
        raise ValueError(f"VLP-16 packet must be {PACKET_SIZE} bytes, got {len(pkt)}")
    raw = np.frombuffer(pkt, np.uint8)
    blocks = raw[:1200].reshape(BLOCKS_PER_PACKET, 100)
    az = (blocks[:, 2].astype(np.uint32) | (blocks[:, 3].astype(np.uint32) << 8))
    azimuths = az.astype(np.float32) / 100.0
    ch = blocks[:, 4:100].reshape(BLOCKS_PER_PACKET, CHANNELS_PER_BLOCK, 3)
    dist = (ch[:, :, 0].astype(np.uint32) | (ch[:, :, 1].astype(np.uint32) << 8))
    distances = dist.astype(np.float32) * DISTANCE_RESOLUTION
    intensities = ch[:, :, 2].copy()
    return azimuths, distances, intensities


def _polar_to_xyz(azimuths_deg: torch.Tensor, distances: torch.Tensor,
                  intensities: torch.Tensor) -> torch.Tensor:
    """(F,) azimuths x (F, 16) ranges -> (F*16, 5) xyzi + ring. Velodyne
    frame: x forward, y left, z up; azimuth clockwise from +y."""
    az = torch.deg2rad(azimuths_deg)[:, None]
    el = torch.deg2rad(torch.as_tensor(ELEVATIONS_DEG, device=distances.device))[None, :]
    r = distances
    cos_el = torch.cos(el)
    x = r * cos_el * torch.sin(az)
    y = r * cos_el * torch.cos(az)
    z = r * torch.sin(el)
    ring = torch.arange(16, dtype=torch.float32, device=r.device)[None].expand(r.shape)
    pts = torch.stack([x, y, z, intensities.to(torch.float32), ring], dim=-1)
    return pts.reshape(-1, 5)


class LidarVLP16:
    """Accumulates packets into full-revolution LaserScans on ``device``
    (None = the CUDA card).

    ``packets``: an iterable of 1206-byte buffers (a pcap replay, a test
    generator, or ``udp_packets``)."""

    def __init__(self, packets: Optional[Iterable[bytes]] = None, local_transform=None,
                 min_range: float = 0.4, max_range: float = 100.0,
                 device: DeviceLike = None):
        self.packets = packets
        self.local_transform = local_transform
        self.min_range = min_range
        self.max_range = max_range
        self.device = resolve_device(device)

    @staticmethod
    def udp_packets(port: int = 2368, timeout: float = 1.0) -> Iterator[bytes]:
        """Live capture (reference: the PCL velodyne UDP capture)."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("", port))
        sock.settimeout(timeout)
        try:
            while True:
                data, _ = sock.recvfrom(PACKET_SIZE + 64)
                if len(data) == PACKET_SIZE:
                    yield data
        finally:
            sock.close()

    def __iter__(self) -> Iterator[LaserScan]:
        if self.packets is None:
            raise RuntimeError("no packet source configured")
        az_acc: List[np.ndarray] = []
        d_acc: List[np.ndarray] = []
        i_acc: List[np.ndarray] = []
        last_az = None
        for pkt in self.packets:
            az, dist, inten = decode_packet(pkt)
            # each block holds two 16-laser firings at the same azimuth word
            az2 = np.repeat(az, 2)
            # the second firing's azimuth half a step forward
            step = np.diff(az, append=az[-1:] + (az[-1] - az[-2] if len(az) > 1 else 0.4))
            az2[1::2] += (step % 360.0) / 2.0
            d2 = dist.reshape(-1, 16)
            i2 = inten.reshape(-1, 16)
            # revolution boundary: the azimuth wraps
            if last_az is not None and len(az2) and az2[0] < last_az - 180.0:
                if az_acc:
                    yield self._emit(az_acc, d_acc, i_acc)
                az_acc, d_acc, i_acc = [], [], []
            az_acc.append(az2)
            d_acc.append(d2)
            i_acc.append(i2)
            last_az = az2[-1] % 360.0
        if az_acc:
            yield self._emit(az_acc, d_acc, i_acc)

    def _emit(self, az_acc, d_acc, i_acc) -> LaserScan:
        dev = self.device
        t = lambda a: torch.from_numpy(np.concatenate(a)).to(dev)  # noqa: E731
        pts = _polar_to_xyz(t(az_acc), t(d_acc), t(i_acc))
        rng = torch.linalg.norm(pts[:, :3], dim=-1)
        valid = (rng > self.min_range) & (rng < self.max_range)
        return make_scan(pts[:, :4], fmt=ScanFormat.XYZI, valid=valid,
                         max_range=self.max_range, local_transform=self.local_transform,
                         device=dev)


def deskew(points, times, velocity_twist, stamp: float = 0.0,
           device: DeviceLike = None) -> torch.Tensor:
    """Constant-velocity LiDAR deskewing (reference: util3d::deskew): points
    captured at per-point ``times`` during a sweep are re-expressed in the
    frame at ``stamp``. ``points`` (N,3) in the sensor frame, ``times``
    (N,) seconds, ``velocity_twist`` (6,) se(3) a second. One batched
    exp-map over the points on ``device`` (None = the points' device when
    they are a tensor, else the CUDA card)."""
    from rtabmap_tpu_torch.geometry import transform as T

    dev = points.device if device is None and isinstance(points, torch.Tensor) \
        else resolve_device(device)
    as_t = lambda x: torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)  # noqa: E731
                                     else x, dtype=torch.float32).to(dev)
    pts, xi = as_t(points), as_t(velocity_twist)
    dt = as_t(times) - stamp
    Ts = T.se3_exp(xi[None] * dt[:, None])                # (N,3,4)
    return torch.einsum("nij,nj->ni", Ts[:, :, :3], pts) + Ts[:, :, 3]

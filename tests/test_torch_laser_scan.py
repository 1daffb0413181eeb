"""Laser scans and the VLP-16 sensor: the port's core/laser_scan.py and
sensors/lidar.py against their JAX twins on the same numpy inputs, and
the packet layout of tools/rgbd_scan.py.

Tolerances and why: packets byte for byte, masks, formats and the point
order of scan_from_depth exactly (integer or byte outputs); scan data that
only moves through make_scan exactly; points from cloud_from_depth within
1e-6 m (the same float32 back-projection, summed in another order);
points from the polar conversion within 2e-5 m at up to 30 m range (the
port's sin/cos come from another library than XLA's); deskewed points
within 1e-5 m (float32 exp-maps)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.core import laser_scan as JLS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.sensors import lidar as JL
from rtabmap_tpu_torch.core import laser_scan as LS
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import cloud as CL
from rtabmap_tpu_torch.sensors import lidar as L
from rtabmap_tpu_torch.tools import rgbd_scan as RSC
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fmt", list(LS.ScanFormat), ids=lambda f: f.name)
def test_make_scan_every_format(fmt):
    rng = np.random.default_rng(int(fmt))
    n = 50
    data = rng.normal(size=(n, LS._CHANNELS[fmt])).astype(np.float32)
    valid = rng.random(n) > 0.2
    lt = np.eye(3, 4, dtype=np.float32)
    for cap in (None, 32, 64):
        j = JLS.make_scan(data, JLS.ScanFormat(int(fmt)), valid=valid, max_range=9.0,
                          capacity=cap, local_transform=lt)
        t = LS.make_scan(data, fmt, valid=valid, max_range=9.0, capacity=cap,
                         local_transform=lt, device="cpu")
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.xyz().numpy(), np.asarray(j.xyz()))
        assert (t.normals() is None) == (j.normals() is None)
        if j.normals() is not None:
            np.testing.assert_array_equal(t.normals().numpy(), np.asarray(j.normals()))
        assert (t.is_2d, t.has_normals, t.format, t.max_range) == \
            (j.is_2d, j.has_normals, j.format, j.max_range)
        np.testing.assert_array_equal(t.local_transform.numpy(), np.asarray(j.local_transform))
    assert t.to("cpu") is t


def test_scan_from_depth_order():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 10.0, (48, 64)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0
    jc = JC.CameraModel.make(50.0, 50.0, 31.5, 23.5, 64, 48)
    tc = C.CameraModel.make(50.0, 50.0, 31.5, 23.5, 64, 48)
    for cap in (20, 48, 200):
        j = JLS.scan_from_depth(jnp.asarray(depth), jc, decimation=4, max_range=8.0,
                                capacity=cap)
        t = LS.scan_from_depth(torch.from_numpy(depth), tc, decimation=4, max_range=8.0,
                               capacity=cap)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), atol=1e-6)
        # the valid points first, each class in image order
        v = t.valid.numpy()
        assert not (~v[:-1] & v[1:]).any()


def _packet_arrays(seed):
    rng = np.random.default_rng(seed)
    az = np.sort(rng.uniform(0, 360, 12)).astype(np.float32)
    dist = rng.uniform(0.0, 120.0, (12, 32)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.1] = 0.0
    inten = rng.integers(0, 256, (12, 32))
    return az, dist, inten


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packets_byte_identical_and_decoded_alike(seed):
    az, dist, inten = _packet_arrays(seed)
    for args in ((az, dist, inten), (az, dist)):
        pj, pt = JL.encode_packet(*args), L.encode_packet(*args)
        assert pt == pj and len(pt) == L.PACKET_SIZE
        for a, b in zip(L.decode_packet(pt), JL.decode_packet(pj)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        L.decode_packet(pt[:-1])


def test_polar_to_xyz():
    rng = np.random.default_rng(4)
    az = rng.uniform(0, 360, 40).astype(np.float32)
    d = rng.uniform(0, 30, (40, 16)).astype(np.float32)
    it = rng.integers(0, 256, (40, 16)).astype(np.uint8)
    j = np.asarray(JL._polar_to_xyz(jnp.asarray(az), jnp.asarray(d), jnp.asarray(it)))
    t = L._polar_to_xyz(torch.from_numpy(az), torch.from_numpy(d), torch.from_numpy(it)).numpy()
    np.testing.assert_allclose(t, j, atol=2e-5)


def _revolutions(n_azimuth=120, n_rev=3, seed=5):
    """Packets of ``n_rev`` simulated revolutions, laid out by tools/rgbd_scan.py."""
    rng = np.random.default_rng(seed)
    packets = []
    for _ in range(n_rev):
        ranges = rng.uniform(0.2, 40.0, (n_azimuth, 16)).astype(np.float32)
        ranges[rng.random(ranges.shape) < 0.1] = 0.0
        packets += [L.encode_packet(*f) for f in RSC.packet_fields(ranges)]
    return packets


@pytest.mark.parametrize("n_azimuth", [120, 225])
def test_lidar_vlp16_scans(n_azimuth):
    packets = _revolutions(n_azimuth)
    js = list(JL.LidarVLP16(packets, min_range=0.4, max_range=30.0))
    ts = list(L.LidarVLP16(packets, min_range=0.4, max_range=30.0, device="cpu"))
    assert len(ts) == len(js) == 3
    for t, j in zip(ts, js):
        assert t.format == j.format == int(L.ScanFormat.XYZI)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), atol=2e-5)
    with pytest.raises(RuntimeError):
        next(iter(L.LidarVLP16(None, device="cpu")))


def test_tool_packets_reproduce_the_simulated_scan():
    """tools/rgbd_scan.py's packet layout: the decoded scan holds the simulated
    points (to the packets' 2 mm range and 0.01 degree azimuth steps), its
    node-frame copy is the base-frame scan rotated into the camera, and
    its mask is the SCAN_VOXEL filter of the points in range."""
    from rtabmap_tpu_torch.datasets import synthetic as S

    pose = S.loop_trajectory(48, radius=1.5, height=0.05)[7]
    world = S.DEFAULT_WORLD.half_extent
    pts, valid = S.lidar_scan(RSC.lidar_pose(pose), n_azimuth=225, n_rings=16,
                              room_half=RSC.lidar_room(world), pillars=(),
                              elev_span=S.VLP16_ELEV_SPAN, device="cpu")
    scan, xyz_b, in_range = RSC.vlp16_scan(pose, world, 225, torch.device("cpu"))
    assert scan.data.shape == (3840, 4) and int(in_range.sum()) == int(valid.sum())
    assert torch.equal(scan.valid, CL.voxel_filter(scan.xyz(), in_range, RSC.SCAN_VOXEL))
    d = torch.cdist(xyz_b[in_range], pts[valid]).min(dim=1).values
    assert float(d.max()) < 5e-3
    # in the node frame the points lie on the room's walls, in the world
    torch.testing.assert_close(scan.xyz() @ torch.from_numpy(RSC.R_CB), xyz_b)
    R, t = pose[:, :3], pose[:, 3]
    w = scan.xyz()[in_range].numpy() @ R.T + t
    hx, hy, hz = world
    on_wall = np.minimum(np.abs(hx - np.abs(w[:, 0])), np.abs(hz - np.abs(w[:, 2])))
    assert on_wall.max() < 5e-3
    grid = RSC.scan_grid(xyz_b, in_range)
    assert int(grid.obstacles_valid.sum()) > 500


def test_deskew():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 5
    times = rng.uniform(0, 0.1, 200).astype(np.float32)
    xi = np.array([0.5, -0.1, 0.05, 0.02, -0.03, 0.4], np.float32)
    j = np.asarray(JL.deskew(pts, times, xi, stamp=0.05))
    t = L.deskew(pts, times, xi, stamp=0.05, device="cpu").numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)

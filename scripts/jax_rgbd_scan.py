"""Reference run of the JAX package for the port's RGB-D + LiDAR checks.

Runs ``rtabmap_tpu_torch/tools/rgbd_scan.py``'s ``parity`` sequence
(``tests/test_slam_e2e.py``'s 58 frames at 320x240 with 16 x 225 VLP-16
scans; ``RGBD/NeighborLinkRefining``, ``VhEp/Enabled``,
``Rtabmap/CreateIntermediateNodes``, ``Rtabmap/DetectionRate`` 0.5)
through the JAX package on the CPU: the JAX renderer and LiDAR simulator,
the JAX package's ``encode_packet`` and ``LidarVLP16`` (the packets laid
out by the port's ``packet_fields``, numpy), its ``LaserScan`` and
``local_grid_from_cloud``, and its ``run_dataset`` with each frame's scan
and grid handed to ``Rtabmap.process`` (the JAX ``run_dataset`` passes
none, so ``process`` is wrapped to add them by stamp). Prints one JSON
line: the port's ``rgbd_scan.counts``. ``chip_smoke.py`` takes its
parity thresholds from these numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_rgbd_scan.py [--seed S] [--frames N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time


def _seed_engines(seed: int):
    """Shift the RANSAC keys of the JAX odometry (seed) and engine (42 +
    seed) as ``run_dataset(seed=...)`` does in the port."""
    import functools

    from rtabmap_tpu.engine.rtabmap import Rtabmap
    from rtabmap_tpu.odometry.f2m import OdometryF2M

    for cls, value in ((OdometryF2M, seed), (Rtabmap, 42 + seed)):
        cls.__init__ = functools.partialmethod(cls.__init__, seed=value)


@contextlib.contextmanager
def _scans_by_stamp(table):
    """``Rtabmap.process`` gets ``scan=`` and ``grid=`` from ``table[stamp]``."""
    from rtabmap_tpu.engine.rtabmap import Rtabmap

    process = Rtabmap.process

    def with_scan(self, frame, odom_pose, covariance=None, stamp=0.0, **kw):
        scan, grid = table.pop(stamp)
        return process(self, frame, odom_pose, covariance, stamp=stamp, scan=scan,
                       grid=grid, **kw)

    Rtabmap.process = with_scan
    try:
        yield
    finally:
        Rtabmap.process = process


def sensor_scan(pose, world_half, n_azimuth: int):
    """The JAX package's twin of ``rgbd_scan.sensor_scan``."""
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.core.laser_scan import ScanFormat, make_scan
    from rtabmap_tpu.datasets.synthetic import lidar_scan
    from rtabmap_tpu.maps.grids import local_grid_from_cloud
    from rtabmap_tpu.ops import cloud as CL
    from rtabmap_tpu.sensors.lidar import LidarVLP16, encode_packet
    from rtabmap_tpu_torch.datasets.synthetic import VLP16_ELEV_SPAN, VLP16_RINGS
    from rtabmap_tpu_torch.tools import rgbd_scan as RSC

    pts, valid = lidar_scan(jnp.asarray(RSC.lidar_pose(pose)), n_azimuth=n_azimuth,
                            n_rings=VLP16_RINGS, room_half=RSC.lidar_room(world_half),
                            pillars=(), elev_span=VLP16_ELEV_SPAN)
    ranges = np.where(np.asarray(valid), np.linalg.norm(np.asarray(pts), axis=-1), 0.0)
    packets = [encode_packet(*f) for f in RSC.packet_fields(
        ranges.reshape(n_azimuth, VLP16_RINGS).astype(np.float32))]
    raw = next(iter(LidarVLP16(packets)))
    xyz_b = raw.xyz()
    xyz_c = xyz_b @ jnp.asarray(RSC.R_CB.T)
    scan = make_scan(jnp.concatenate([xyz_c, raw.data[:, 3:4]], axis=-1), ScanFormat.XYZI,
                     valid=CL.voxel_filter(xyz_c, raw.valid, RSC.SCAN_VOXEL),
                     max_range=raw.max_range)
    gv = CL.voxel_filter(xyz_b, raw.valid & (jnp.abs(xyz_b[:, 2]) < RSC.GRID_HEIGHT),
                         RSC.SCAN_VOXEL)
    normals, _ = CL.estimate_normals(xyz_b, gv, k=8)
    grid = local_grid_from_cloud(xyz_b, gv, normals, cell_size=RSC.GRID_CELL,
                                 max_points=int(xyz_b.shape[0]))
    return scan, grid


def run(seed: int = 0, frames: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtabmap_tpu.datasets.readers import Frame
    from rtabmap_tpu.datasets.synthetic import World, render
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.tools.dataset_runner import run_dataset
    from rtabmap_tpu.utils.params import Parameters
    from rtabmap_tpu_torch.tools import rgbd_scan as RSC
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    spec = sequence_spec("parity")
    W, H = spec["size"]
    cam = C.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    world = World(half_extent=jnp.asarray(spec["world"], jnp.float32), seed=0)
    rfn = jax.jit(lambda pose: render(pose, cam, world))
    poses = spec["poses"][: frames or None]
    table = {}

    def stream():
        for i, pose in enumerate(poses):
            gray, depth = rfn(pose)
            table[float(i)] = sensor_scan(pose, spec["world"], RSC.AZIMUTHS["parity"])
            yield Frame(stamp=float(i), gray=np.asarray(gray), depth=np.asarray(depth),
                        gt_pose=np.asarray(pose))

    t0 = time.time()
    with _scans_by_stamp(table):
        out = run_dataset(stream(), cam, Parameters(RSC.RUN_PARAMS["parity"]),
                          max_kp=spec["max_kp"], node_capacity=spec["node_capacity"],
                          verbose=False)
    return {"run": "parity", "seed": seed, **RSC.counts(out["slam"], out),
            "seconds": round(time.time() - t0, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC keys")
    ap.add_argument("--frames", type=int, default=0, help="cut the sequence (0 = whole)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.seed:
        _seed_engines(args.seed)
    print(json.dumps(run(args.seed, args.frames)), flush=True)


if __name__ == "__main__":
    main()

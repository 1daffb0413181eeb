"""Reference run of the JAX package for the port's LiDAR mapping check.

Builds the sequence that ``chip_smoke.py`` drives through the port at its
parity width: ``lidar_trajectory(150, radius=2.0)`` (one closed 12.6 m loop,
0.084 m a frame), a VLP-16 cut to ``--n-azimuth`` azimuth steps (16 rings,
+-15 degrees), sensor-frame noise of sigma 0.01 m from
``numpy.random.default_rng(0)`` (``rtabmap_tpu_torch.datasets.synthetic.
sensor_noise``, drawn frame by frame, as the port's run draws it). The
scans go through the JAX package's ``run_lidar_mapping`` on the CPU, with
its default ``Icp/*`` parameters. Prints nodes, closures, lost frames, both
ATEs against the simulator's poses, and the run time. ``chip_smoke.py``
takes its parity thresholds from these numbers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/jax_lidar_mapping.py [--frames 150] [--n-azimuth 225]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--n-azimuth", type=int, default=225)
    ap.add_argument("--n-rings", type=int, default=16)
    ap.add_argument("--noise", type=float, default=0.01)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from rtabmap_tpu.datasets import synthetic as S
    from rtabmap_tpu.tools.lidar_mapping import run_lidar_mapping
    from rtabmap_tpu_torch.datasets.synthetic import VLP16_ELEV_SPAN, sensor_noise

    poses = np.asarray(S.lidar_trajectory(args.frames, radius=2.0))
    rng = np.random.default_rng(0)
    n_points = args.n_azimuth * args.n_rings

    def scans():
        for pose in poses:
            pts, valid = S.lidar_scan(pose, n_azimuth=args.n_azimuth,
                                      n_rings=args.n_rings,
                                      elev_span=VLP16_ELEV_SPAN)
            yield np.asarray(pts) + sensor_noise(rng, n_points, args.noise), np.asarray(valid)

    t0 = time.time()
    out = run_lidar_mapping(scans(), gt_poses=poses)
    print(json.dumps({
        "frames": args.frames, "n_azimuth": args.n_azimuth, "n_rings": args.n_rings,
        "points": n_points, "noise": args.noise, "nodes": out["nodes"],
        "closures": len(out["closures"]), "lost": out["lost"],
        "ate_slam": out.get("ate_slam"), "ate_odom": out.get("ate_odom"),
        "occupied_voxels": out.get("occupied_voxels"),
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()

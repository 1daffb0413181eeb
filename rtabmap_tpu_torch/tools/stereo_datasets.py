"""The stereo and visual-inertial runs: synthetic sequences in the public
datasets' layouts, through the dataset tools.

Each run writes its layout (``datasets/layouts.py``) into a directory and
runs one of ``tools/cli.py``'s dataset tools on it, as a user would run it
on a recorded sequence (every frame processed: ``Rtabmap/DetectionRate``
0). The runs:

- ``parity``: the RGB-D parity trajectory (``tests/test_slam_e2e.py``'s
  58 frames, ``rgbd_laps.sequence_spec("parity")``) at 320x240, fx = fy =
  300, as a KITTI layout with a right image at a 0.11 m baseline, through
  ``kitti_dataset``;
- ``full``: EuRoC cam0's published geometry (752x480, fx 458.654, fy
  457.296, cx 367.215, cy 248.375, 0.11 m baseline; no distortion: the
  renderer has none), the two 60-frame laps of ``rgbd_laps``' full
  sequence in its 16 x 12 x 16 m hall, through ``euroc_dataset``;
- ``kitti``: KITTI 00's calibration (1241x376, fx = fy = 718.856, cx
  607.1928, cy 185.2157, 0.5372 m baseline, so a disparity of 386 / z px:
  points nearer than 3 m fail the 128 px limit) on the first 40 poses of a
  60-frame lap in a 32 x 24 x 32 m hall (``KITTI_WORLD``), whose walls
  stand 14.5-22 m off (17-27 px), through ``kitti_dataset`` with its
  poses file. In the 16 m hall (38-59 px) the 1-D LK, three pyramid
  levels of 8 steps clipped to 2 px, gives fewer of the first frame's
  keypoints a stereo point (54% against 75% here) and the JAX package's
  odometry loses most frames;
- ``imu0`` / ``imu1``: a CID-SIMS layout at 640x480 (its calibration)
  with 16-bit depth and a 200 Hz ``imu.txt``: a rocking ground robot whose
  camera looks at the hall's ceiling 6 m up, a 48-frame circle and its
  first 10 frames again (``layouts.ceiling_trajectory``), through
  ``cid_sims_dataset --gt --imu 0`` (Madgwick) and ``--imu 1``
  (complementary).

``scripts/jax_stereo_datasets.py`` writes the same layouts with the same
writer and runs the JAX package's tools on them; ``chip_smoke.py`` runs
the port's on the card and holds them to those numbers.

Usage: python -m rtabmap_tpu_torch.tools.stereo_datasets [--device cpu]
       [--runs parity full kitti imu0 imu1] [--frames N]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from rtabmap_tpu_torch.datasets import layouts as L
from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD, World, loop_trajectory
from rtabmap_tpu_torch.device import DeviceLike
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.tools.rgbd_laps import FULL_WORLD, sequence_spec

RUNS = ("parity", "full", "kitti", "imu0", "imu1")
EUROC_CAM0 = (458.654, 457.296, 367.215, 248.375)
EUROC_SIZE = (752, 480)
KITTI00 = (718.856, 718.856, 607.1928, 185.2157)
KITTI00_BASELINE = 386.1448 / 718.856
KITTI_SIZE = (1241, 376)
BASELINE = 0.11
HALL = World(FULL_WORLD, DEFAULT_WORLD.seed)
KITTI_WORLD = World((16.0, 12.0, 16.0), DEFAULT_WORLD.seed)
EVERY_FRAME = ["--Rtabmap/DetectionRate", "0"]


def poses_of(run: str) -> np.ndarray:
    """The run's poses (camera-in-world; earth frame for the IMU runs)."""
    if run == "parity":
        return sequence_spec("parity")["poses"]
    if run == "full":
        return sequence_spec("full")["poses"]
    if run == "kitti":
        return loop_trajectory(60)[:40]
    if run in ("imu0", "imu1"):
        return L.ceiling_trajectory(48, 10)
    raise KeyError(f"unknown run {run!r}; use one of {RUNS}")


def tool_args(run: str, root: str) -> List[str]:
    """The dataset tool's arguments for the run's layout under ``root``:
    [tool, options..., paths...]."""
    d = os.path.join(root, "imu" if run.startswith("imu") else run)
    kitti = ["kitti_dataset", *EVERY_FRAME, os.path.join(d, "sequences", "00"),
             os.path.join(d, "poses", "00.txt")]
    if run in ("parity", "kitti"):
        return kitti
    if run == "full":
        return ["euroc_dataset", *EVERY_FRAME, os.path.join(d, "MH_synth")]
    if run in ("imu0", "imu1"):
        return ["cid_sims_dataset", *EVERY_FRAME, "--gt", "--imu", run[-1],
                os.path.join(d, "cid_synth")]
    raise KeyError(f"unknown run {run!r}; use one of {RUNS}")


def write_layout(run: str, root: str, device: DeviceLike = None, frames: int = 0) -> List[str]:
    """Write the run's layout into a directory of its own under ``root``
    (rendered on ``device``; the IMU runs share one) and return
    ``tool_args(run, root)``."""
    poses = poses_of(run)
    poses = poses[:frames] if frames else poses
    args = tool_args(run, root)
    if run == "parity":
        L.write_kitti(args[-2], args[-1], poses, (320, 240), (300.0, 300.0, 160.0, 120.0),
                      BASELINE, DEFAULT_WORLD, device)
    elif run == "full":
        L.write_euroc(args[-1], poses, EUROC_SIZE, EUROC_CAM0, BASELINE, HALL, device)
    elif run == "kitti":
        L.write_kitti(args[-2], args[-1], poses, KITTI_SIZE, KITTI00, KITTI00_BASELINE,
                      KITTI_WORLD, device)
    elif not os.path.isdir(args[-1]):
        L.write_cid_sims(args[-1], poses, (640, 480), HALL, device=device)
    return args


def rpy_of_quat(q) -> np.ndarray:
    """(roll, pitch) of orientation quaternions [x,y,z,w] (N,4)."""
    rpy = T.to_xyzrpy(T.from_quaternion(torch.as_tensor(np.asarray(q, np.float32))))
    return rpy[..., 3:5].numpy()


def summary(out: Dict) -> Dict:
    """The numbers a run is held to, and its per-frame times."""
    slam = out["slam"]
    hist = slam.stats_history
    def ms(x):
        return {"median": float(np.median(x)), "p90": float(np.percentile(x, 90))} if x else None

    res = {"frames": out["frames"], "loops": out["loops"], "lost": out["lost"],
           "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
           "nodes": len(slam.memory.signatures), "n_words": slam.memory.vocab.n_words,
           "quantize_calls": sum("TimingMem/Add new words/ms" in s.data for s in hist),
           "extract_ms": ms(out["extract_ms"]), "imu_ms": ms(out["imu_ms"]),
           "odom_ms": ms(out["odom_ms"]), "process_ms": ms(out["process_ms"])}
    for k in ("ate_odom", "ate_slam", "kitti_t_err_pct", "kitti_r_err_deg_per_m"):
        if k in out:
            res[k] = float(out[k])
    tracked = [k for k, q in enumerate(out["imu_quat"]) if q is not None and out["tracked"][k]]
    if tracked:
        # the tracked poses' roll and pitch against the integrated IMU's
        rp_pose = np.array([T.np_to_xyzrpy(out["est_odom"][k])[3:5] for k in tracked])
        rp_imu = rpy_of_quat(np.stack([out["imu_quat"][k] for k in tracked]))
        diff = np.abs(np.angle(np.exp(1j * (rp_pose - rp_imu))))
        res["imu_frames"] = len(tracked)
        res["imu_roll_pitch_max_diff_rad"] = float(diff.max())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--frames", type=int, default=0)
    args = ap.parse_args(argv)
    from rtabmap_tpu_torch.tools import cli

    with tempfile.TemporaryDirectory() as root:
        for run in args.runs:
            tool = write_layout(run, root, args.device, args.frames)
            dev = ["--device", args.device] if args.device else []
            out = cli.main(tool + dev)
            print(json.dumps({"run": run, **summary(out)}), flush=True)


if __name__ == "__main__":
    main()

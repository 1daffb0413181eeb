"""Synthetic sequences written into the on-disk layouts of the public
datasets: TUM RGB-D, KITTI odometry, EuRoC MAV (ASL) and CID-SIMS.

The synthetic room (``datasets/synthetic.py``) is rendered on ``device``
and written with the port's own PNG writer (gray as ``uint8(g * 255)``,
depth as 16-bit PNG in the layout's depth unit), beside the text files
each reader parses: TUM's rgb.txt / depth.txt / groundtruth.txt, KITTI's
calib.txt / times.txt / poses file, EuRoC's data.csv / sensor.yaml /
ground-truth csv, CID-SIMS's stamped color/ and depth/ and its
groundtruth.txt and imu.txt. Frames are 0.1 s apart. So the dataset tools
run on the same files a recorded sequence would give them.

A stereo layout renders the right image at the left pose moved
``baseline`` metres along the camera's x axis. The CID-SIMS layout takes
poses in a z-up earth frame (``EARTH_TO_ROOM`` places them in the room,
whose y axis is vertical) and writes an ``imu.txt`` at ``imu_rate`` Hz
made from them: the body rate of the constant rotation between two
frames, and gravity in the body frame as the accelerometer reading.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.datasets.png import write_png
from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD, World, render
from rtabmap_tpu_torch.device import DeviceLike
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T

FRAME_DT = 0.1
GRAVITY = 9.81
# earth (x, y, z up) -> room coordinates: the room's -y is up
EARTH_TO_ROOM = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)


def _gray8(g: torch.Tensor) -> np.ndarray:
    return (g.cpu().numpy() * 255).astype(np.uint8)


def _depth16(d: torch.Tensor, factor: float) -> np.ndarray:
    """Depth in the layout's unit; a depth past 16 bits reads 0 (no return)."""
    v = d.cpu().numpy() * factor
    return np.where(v < 65535.5, v, 0).astype(np.uint16)


def _right_pose(pose: np.ndarray, baseline: float) -> np.ndarray:
    off = np.eye(3, 4, dtype=np.float32)
    off[0, 3] = baseline
    return T.np_compose(pose, off).astype(np.float32)


def _quat_t(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """([qx, qy, qz, qw], t) of a (3,4) pose."""
    P = torch.from_numpy(np.asarray(pose, np.float32))
    return T.to_quaternion(P).numpy(), P[:, 3].numpy()


def _fmt(v) -> str:
    return " ".join(repr(float(x)) for x in np.ravel(v))


def write_tum(root: str, poses: np.ndarray, size: Tuple[int, int], freiburg: int = 2,
              world: World = DEFAULT_WORLD, device: DeviceLike = None) -> C.CameraModel:
    """A TUM RGB-D sequence in ``root`` (its name should hold
    ``freiburg<n>``); the camera is the fr<n> calibration scaled to
    ``size``, as the reader makes it. Returns that camera."""
    from rtabmap_tpu_torch.datasets.readers import TUM_CALIB

    W, H = size
    fx, fy, cx, cy = TUM_CALIB[freiburg]
    sx, sy = W / 640.0, H / 480.0
    cam = C.CameraModel.make(fx * sx, fy * sy, cx * sx, cy * sy, W, H)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rgb, depth, gt = [], [], []
    for i, pose in enumerate(poses):
        g, d = render(pose, cam, world, device=device)
        stamp = f"{1000.0 + i * FRAME_DT:.6f}"
        write_png(os.path.join(root, "rgb", stamp + ".png"), _gray8(g))
        write_png(os.path.join(root, "depth", stamp + ".png"), _depth16(d, 5000.0))
        rgb.append(f"{stamp} rgb/{stamp}.png")
        depth.append(f"{stamp} depth/{stamp}.png")
        q, t = _quat_t(pose)
        gt.append(f"{stamp} {_fmt(t)} {_fmt(q)}")
    for name, lines in (("rgb", rgb), ("depth", depth), ("groundtruth", gt)):
        with open(os.path.join(root, name + ".txt"), "w") as f:
            f.write(f"# {name}\n" + "\n".join(lines) + "\n")
    return cam


def write_kitti(seq_dir: str, poses_file: str, poses: np.ndarray, size: Tuple[int, int],
                intrinsics: Sequence[float], baseline: float, world: World = DEFAULT_WORLD,
                device: DeviceLike = None) -> C.StereoCameraModel:
    """A KITTI odometry sequence: ``seq_dir``/image_0, image_1, calib.txt
    (P0, P1 with P1[0,3] = -fx * baseline), times.txt, and the ground truth
    at ``poses_file``. Returns the stereo camera."""
    W, H = size
    fx, fy, cx, cy = intrinsics
    stereo = C.StereoCameraModel.make(fx, fy, cx, cy, baseline, W, H)
    cam = stereo.left
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]], np.float64)
    P1 = P0.copy()
    P1[0, 3] = -fx * baseline
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(f"{name}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")
    times, rows = [], []
    for i, pose in enumerate(poses):
        g, _ = render(pose, cam, world, device=device)
        gr, _ = render(_right_pose(pose, baseline), cam, world, device=device)
        write_png(os.path.join(seq_dir, "image_0", f"{i:06d}.png"), _gray8(g))
        write_png(os.path.join(seq_dir, "image_1", f"{i:06d}.png"), _gray8(gr))
        times.append(f"{i * FRAME_DT:.6e}")
        rows.append(_fmt(np.asarray(pose, np.float32)))
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    os.makedirs(os.path.dirname(os.path.abspath(poses_file)), exist_ok=True)
    with open(poses_file, "w") as f:
        f.write("\n".join(rows) + "\n")
    return stereo


def write_euroc(root: str, poses: np.ndarray, size: Tuple[int, int],
                intrinsics: Sequence[float], baseline: float, world: World = DEFAULT_WORLD,
                device: DeviceLike = None) -> C.StereoCameraModel:
    """An EuRoC ASL sequence: mav0/cam0 and cam1 (data/, data.csv,
    sensor.yaml with zero distortion and the baseline) and
    mav0/state_groundtruth_estimate0/data.csv. Returns the stereo camera."""
    W, H = size
    fx, fy, cx, cy = intrinsics
    stereo = C.StereoCameraModel.make(fx, fy, cx, cy, baseline, W, H)
    mav = os.path.join(root, "mav0")
    for cname in ("cam0", "cam1"):
        os.makedirs(os.path.join(mav, cname, "data"), exist_ok=True)
        with open(os.path.join(mav, cname, "sensor.yaml"), "w") as f:
            f.write("sensor_type: camera\n"
                    f"resolution: [{W}, {H}]\n"
                    f"intrinsics: [{fx!r}, {fy!r}, {cx!r}, {cy!r}]\n"
                    "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
                    f"baseline: {baseline!r}\n")
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)
    cam_rows = ["#timestamp [ns],filename"]
    gt_rows = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z"]
    for i, pose in enumerate(poses):
        ns = 1000000000 * 100 + i * int(FRAME_DT * 1e9)
        g, _ = render(pose, stereo.left, world, device=device)
        gr, _ = render(_right_pose(pose, baseline), stereo.left, world, device=device)
        write_png(os.path.join(mav, "cam0", "data", f"{ns}.png"), _gray8(g))
        write_png(os.path.join(mav, "cam1", "data", f"{ns}.png"), _gray8(gr))
        cam_rows.append(f"{ns},{ns}.png")
        q, t = _quat_t(pose)
        gt_rows.append(f"{ns}," + ",".join(repr(float(x)) for x in (*t, q[3], q[0], q[1], q[2])))
    for cname in ("cam0", "cam1"):
        with open(os.path.join(mav, cname, "data.csv"), "w") as f:
            f.write("\n".join(cam_rows) + "\n")
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    return stereo


def ceiling_trajectory(n_lap: int = 48, revisit: int = 10, radius: float = 1.5,
                       roll_amp: float = 0.06, pitch_amp: float = 0.05) -> np.ndarray:
    """(n_lap + revisit, 3, 4) earth-frame camera poses of a ground robot
    whose camera looks up: a circle of ``radius`` in the horizontal plane,
    heading along the circle (yaw = the circle's angle), with the roll and
    pitch of a rocking chassis (periods n_lap/2 and n_lap/3 frames); frame
    0 is level at yaw 0, and the last ``revisit`` frames repeat the first."""
    poses = []
    for k in range(n_lap + revisit):
        i = k % n_lap
        a = 2.0 * np.pi * i / n_lap
        rpy = np.array([radius * np.cos(a), radius * np.sin(a), 0.0,
                        roll_amp * np.sin(2.0 * a), pitch_amp * np.sin(3.0 * a), a],
                       np.float32)
        poses.append(T.from_xyzrpy(torch.from_numpy(rpy)).numpy())
    return np.stack(poses)


def _imu_samples(poses: np.ndarray, stamps: np.ndarray, rate: float):
    """(t, gyro, accel) at ``rate`` Hz from stamps[0] to stamps[-1]: the
    body rate of the constant rotation from frame i to i+1, and the
    accelerometer's reading of gravity (+z in the earth frame) in the body
    frame."""
    out = []
    n = int(round((stamps[-1] - stamps[0]) * rate))
    for k in range(n + 1):
        t = stamps[0] + k / rate
        i = min(int((t - stamps[0] + 1e-9) / FRAME_DT), len(poses) - 2)
        Ri, Rj = poses[i][:, :3].astype(np.float64), poses[i + 1][:, :3].astype(np.float64)
        rel = T.so3_log(torch.from_numpy(Ri.T @ Rj)).numpy()
        omega = rel / (stamps[i + 1] - stamps[i])
        Rt = Ri @ T.so3_exp(torch.from_numpy(omega * (t - stamps[i]))).numpy()
        out.append((t, omega, Rt.T @ np.array([0.0, 0.0, GRAVITY])))
    return out


def write_cid_sims(root: str, poses_earth: np.ndarray, size: Tuple[int, int] = (640, 480),
                   world: World = DEFAULT_WORLD, imu_rate: float = 200.0,
                   device: DeviceLike = None) -> C.CameraModel:
    """A CID-SIMS sequence: color/ and depth/ (16-bit, mm) named by stamp,
    groundtruth.txt (TUM format, earth frame) and imu.txt (``t gx gy gz ax
    ay az``). The camera is the published calibration scaled to ``size``,
    as the reader makes it. Returns that camera."""
    from rtabmap_tpu_torch.datasets.readers import CidSimsDataset

    W, H = size
    fx, fy, cx, cy = CidSimsDataset.CALIB
    sx, sy = W / 640.0, H / 480.0
    cam = C.CameraModel.make(fx * sx, fy * sy, cx * sx, cy * sy, W, H)
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    stamps = 500.0 + np.arange(len(poses_earth)) * FRAME_DT
    gt = []
    for stamp, pose in zip(stamps, poses_earth):
        room = np.concatenate([EARTH_TO_ROOM @ pose[:, :3], (EARTH_TO_ROOM @ pose[:, 3])[:, None]],
                              axis=1).astype(np.float32)
        g, d = render(room, cam, world, device=device)
        write_png(os.path.join(root, "color", f"{stamp:.6f}.png"), _gray8(g))
        write_png(os.path.join(root, "depth", f"{stamp:.6f}.png"), _depth16(d, 1000.0))
        q, t = _quat_t(pose)
        gt.append(f"{stamp:.6f} {_fmt(t)} {_fmt(q)}")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt) + "\n")
    with open(os.path.join(root, "imu.txt"), "w") as f:
        for t, gyro, acc in _imu_samples(poses_earth, stamps, imu_rate):
            f.write(f"{t:.6f} {_fmt(gyro)} {_fmt(acc)}\n")
    return cam

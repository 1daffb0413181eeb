"""Dataset readers: TUM RGB-D, KITTI odometry, EuRoC MAV and CID-SIMS.

Port of ``rtabmap_tpu/datasets/readers.py`` (the reference's file
cameras of its dataset tools: RgbdDataset's fr1/fr2/fr3 calibration
table, KittiDataset's calib.txt, EurocDataset's ASL layout and cam yaml,
CidSimsDataset's stamped color/depth, wheel odometry and imu.txt). Each
reader yields host ``Frame`` records (stamp, gray, depth or right image,
ground truth, external odometry, IMU samples), decoding lazily.

Images are PNG, decoded by ``datasets/png.py`` (gray as PIL's
``convert("L")``); another format raises ``ValueError`` naming it. The
EuRoC ``sensor.yaml`` is read by ``read_sensor_yaml``, which takes the
four keys the reader uses. Beside the twin's fields a ``Frame`` carries
the node's laser scan and local occupancy grid for ``Rtabmap.process``
(``tools/rgbd_scan.py`` fills them).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.datasets.png import read_png, to_gray8
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T


def _load_gray(path: str) -> np.ndarray:
    return to_gray8(read_png(path)).astype(np.float32) / 255.0


def _load_depth_png(path: str, factor: float = 5000.0) -> np.ndarray:
    return read_png(path).astype(np.float32) / factor


@dataclass
class Frame:
    stamp: float
    gray: np.ndarray
    depth: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    gt_pose: Optional[np.ndarray] = None    # (3,4)
    odom_pose: Optional[np.ndarray] = None  # (3,4) external odometry (wheels)
    imu: Optional[List] = None              # [(stamp, gyro(3,), accel(3,))] since
                                            # the previous frame
    scan: Optional[object] = None           # core/laser_scan.LaserScan, node frame
    grid: Optional[object] = None           # maps/grids.LocalGrid, base frame


def _pose_from_quaternion(q, t) -> np.ndarray:
    """(3,4) float32 pose of quaternion [x,y,z,w] and translation."""
    return T.from_quaternion(torch.tensor(np.asarray(q, np.float32)),
                             torch.tensor(np.asarray(t, np.float32))).numpy()


def _nearest(stamped: List[Tuple[float, object]], j: int, stamp: float) -> int:
    """Advance the cursor ``j`` to the entry nearest ``stamp``."""
    while j + 1 < len(stamped) and abs(stamped[j + 1][0] - stamp) <= abs(stamped[j][0] - stamp):
        j += 1
    return j


# ------------------------------------------------------------------ TUM RGB-D

# fr1/fr2/fr3 calibrations (the reference's RgbdDataset table)
TUM_CALIB = {
    1: (517.3, 516.5, 318.6, 255.3),
    2: (520.9, 521.0, 325.1, 249.7),
    3: (535.4, 539.2, 320.1, 247.6),
}


def _read_stamped_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_tum_gt(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            out.append((v[0], _pose_from_quaternion(v[4:8], v[1:4])))   # qx qy qz qw
    return out


def _associate(a: List[Tuple[float, object]], b: List[Tuple[float, object]],
               max_dt: float = 0.02):
    """Greedy nearest-stamp association (the reference's associate.py)."""
    out = []
    j = 0
    for ta, va in a:
        j = _nearest(b, j, ta)
        if b and abs(b[j][0] - ta) <= max_dt:
            out.append((ta, va, b[j][1]))
    return out


class TumRgbdDataset:
    """TUM RGB-D: rgb.txt + depth.txt + groundtruth.txt association. The
    published 640x480 intrinsics are scaled to the images' size."""

    def __init__(self, root: str, freiburg: Optional[int] = None,
                 depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        if freiburg is None:
            name = os.path.basename(os.path.normpath(root))
            freiburg = 1 if "freiburg1" in name else 2 if "freiburg2" in name else 3
        fx, fy, cx, cy = TUM_CALIB[freiburg]
        rgb = _read_stamped_list(os.path.join(root, "rgb.txt"))
        depth = _read_stamped_list(os.path.join(root, "depth.txt"))
        self.pairs = _associate(rgb, depth)
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = _read_tum_gt(gt_path) if os.path.exists(gt_path) else []
        g0 = _load_gray(os.path.join(root, self.pairs[0][1]))
        H, W = g0.shape
        sx, sy = W / 640.0, H / 480.0
        self.camera = C.CameraModel.make(fx * sx, fy * sy, cx * sx, cy * sy, W, H)
        self._first = g0

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[Frame]:
        j = 0
        for i, (stamp, rgb_rel, depth_rel) in enumerate(self.pairs):
            gray = self._first if i == 0 else _load_gray(os.path.join(self.root, rgb_rel))
            depth = _load_depth_png(os.path.join(self.root, depth_rel), self.depth_factor)
            pose = None
            if self.gt:
                j = _nearest(self.gt, j, stamp)
                if abs(self.gt[j][0] - stamp) < 0.05:
                    pose = self.gt[j][1]
            yield Frame(stamp=stamp, gray=gray, depth=depth, gt_pose=pose)


# ------------------------------------------------------------- KITTI odometry


class KittiDataset:
    """KITTI odometry: image_0/image_1 stereo grays + calib.txt + times.txt
    (+ poses/<seq>.txt ground truth)."""

    def __init__(self, seq_dir: str, poses_file: Optional[str] = None):
        self.root = seq_dir
        calib = {}
        with open(os.path.join(seq_dir, "calib.txt")) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    calib[k.strip()] = np.array(v.split(), np.float64)
        P0 = calib["P0"].reshape(3, 4)
        P1 = calib["P1"].reshape(3, 4)
        fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
        baseline = -P1[0, 3] / P1[0, 0]
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_files = sorted(os.listdir(os.path.join(seq_dir, "image_0")))
        g0 = _load_gray(os.path.join(seq_dir, "image_0", self.left_files[0]))
        H, W = g0.shape
        self.camera = C.CameraModel.make(fx, fy, cx, cy, W, H)
        self.stereo = C.StereoCameraModel.make(fx, fy, cx, cy, baseline, W, H)
        self.gt_poses = None
        if poses_file and os.path.exists(poses_file):
            self.gt_poses = np.loadtxt(poses_file, dtype=np.float32).reshape(-1, 3, 4)

    def __len__(self):
        return len(self.left_files)

    def __iter__(self) -> Iterator[Frame]:
        for i, name in enumerate(self.left_files):
            gray = _load_gray(os.path.join(self.root, "image_0", name))
            right = _load_gray(os.path.join(self.root, "image_1", name))
            gt = self.gt_poses[i] if self.gt_poses is not None else None
            yield Frame(stamp=self.times[i], gray=gray, right=right, gt_pose=gt)


# ------------------------------------------------------------------- EuRoC


def _yaml_scalar(tok: str):
    tok = tok.strip().strip("'\"")
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def read_sensor_yaml(path: str) -> Dict[str, object]:
    """The top-level ``key: value`` entries of an ASL ``sensor.yaml``:
    scalars and flow lists (``[a, b, ...]``, which may span lines) as
    numbers or strings. Indented blocks (``T_BS``'s rows/cols/data) and
    ``%YAML`` directives are skipped; comments are dropped. Raises
    ``ValueError`` on a line it cannot read."""
    out: Dict[str, object] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line.strip() or line.startswith(("%", "---")) or line[0] in " \t":
            continue
        if ":" not in line:
            raise ValueError(f"{path}: cannot read line {line!r}")
        key, val = line.split(":", 1)
        val = val.strip()
        if val.startswith("["):
            while "]" not in val:
                if i >= len(lines):
                    raise ValueError(f"{path}: unterminated list for {key!r}")
                val += " " + lines[i].split("#", 1)[0].strip()
                i += 1
            body = val[1:val.index("]")]
            out[key.strip()] = [_yaml_scalar(x) for x in body.split(",") if x.strip()]
        elif val:
            out[key.strip()] = _yaml_scalar(val)
        else:
            out[key.strip()] = None      # a block follows, indented
    return out


class EurocDataset:
    """EuRoC ASL: mav0/cam0,cam1 stereo + state_groundtruth_estimate0, the
    calibration from mav0/cam0/sensor.yaml (nominal cam0 values when it is
    missing or unreadable)."""

    def __init__(self, root: str):
        self.root = root
        cam0 = os.path.join(root, "mav0", "cam0")
        self.cam0_dir = os.path.join(cam0, "data")

        def read_csv(path):
            with open(path) as f:
                return [row for row in csv.reader(f) if row and not row[0].startswith("#")]

        self.rows = read_csv(os.path.join(cam0, "data.csv"))
        fx, fy, cx, cy = 458.654, 457.296, 367.215, 248.375
        W, H = 752, 480
        dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0],
                        np.float32)
        baseline = 0.11
        yml = os.path.join(cam0, "sensor.yaml")
        if os.path.exists(yml):
            try:
                cal = read_sensor_yaml(yml)
                if cal.get("intrinsics"):
                    fx, fy, cx, cy = [float(x) for x in cal["intrinsics"]]
                if cal.get("resolution"):
                    W, H = [int(x) for x in cal["resolution"]]
                dc = cal.get("distortion_coefficients")
                if dc is not None:
                    d5 = np.zeros(5, np.float32)
                    d5[: min(len(dc), 5)] = np.asarray(dc[:5], np.float32)
                    dist = d5 if np.abs(d5).sum() > 0 else None
                if cal.get("baseline"):
                    baseline = float(cal["baseline"])
            except Exception:   # an unreadable file leaves the nominal values
                pass
        self.camera = C.CameraModel.make(fx, fy, cx, cy, W, H, dist=dist)
        self.stereo = C.StereoCameraModel.make(fx, fy, cx, cy, baseline, W, H)
        gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
        self.gt = []
        if os.path.exists(gt_csv):
            for row in read_csv(gt_csv):
                t = [float(row[1]), float(row[2]), float(row[3])]
                qw, qx, qy, qz = (float(row[4]), float(row[5]), float(row[6]), float(row[7]))
                self.gt.append((float(row[0]) * 1e-9, _pose_from_quaternion([qx, qy, qz, qw], t)))

    def __len__(self):
        return len(self.rows)

    def __iter__(self) -> Iterator[Frame]:
        j = 0
        for row in self.rows:
            stamp = float(row[0]) * 1e-9
            name = row[1].strip()
            gray = _load_gray(os.path.join(self.cam0_dir, name))
            right_path = os.path.join(self.root, "mav0", "cam1", "data", name)
            right = _load_gray(right_path) if os.path.exists(right_path) else None
            pose = None
            if self.gt:
                j = _nearest(self.gt, j, stamp)
                if abs(self.gt[j][0] - stamp) < 0.05:
                    pose = self.gt[j][1]
            yield Frame(stamp=stamp, gray=gray, right=right, gt_pose=pose)


# ----------------------------------------------------------------- CID-SIMS


class CidSimsDataset:
    """CID-SIMS ground-robot RGB-D sequences (the reference's
    CidSimsDataset): ``color/`` + ``depth/`` images named by their stamps,
    ``groundtruth.txt`` in TUM format, ``odom.txt`` rows of 14 columns
    dead-reckoned into planar odometry (vx at column 8, vtheta at 13),
    ``imu.txt`` gyro + accel samples. The published 640x480 RealSense
    calibration is scaled to the images' size."""

    CALIB = (386.52199190267083, 387.32300428823663,
             326.5103569741365, 237.40293732598795)

    def __init__(self, root: str, depth_factor: float = 1000.0,
                 use_odom: bool = False, use_imu: bool = False,
                 max_time_diff: float = 0.1):
        self.root = root
        self.depth_factor = depth_factor
        self.max_time_diff = max_time_diff

        def stamped_dir(sub):
            out = []
            for name in sorted(os.listdir(os.path.join(root, sub))):
                try:
                    out.append((float(os.path.splitext(name)[0]), os.path.join(sub, name)))
                except ValueError:
                    continue
            return out

        self.pairs = _associate(stamped_dir("color"), stamped_dir("depth"),
                                max_dt=max_time_diff)
        if not self.pairs:
            raise FileNotFoundError(f"no associated color/depth in {root}")
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = _read_tum_gt(gt_path) if os.path.exists(gt_path) else []

        self.odom: List[Tuple[float, np.ndarray]] = []
        odom_path = os.path.join(root, "odom.txt")
        if use_odom and os.path.exists(odom_path):
            x = y = theta = 0.0
            prev = None
            with open(odom_path) as f:
                for line in f:
                    vals = line.replace(",", " ").split()
                    if len(vals) != 14:
                        continue
                    stamp = float(vals[0])
                    if prev is None:
                        prev = stamp
                    dt = stamp - prev
                    vx, vtheta = float(vals[8]), float(vals[13])
                    x += vx * np.cos(theta) * dt
                    y += vx * np.sin(theta) * dt
                    theta += vtheta * dt
                    prev = stamp
                    c, s = np.cos(theta), np.sin(theta)
                    self.odom.append((stamp, np.asarray([[c, -s, 0, x], [s, c, 0, y],
                                                         [0, 0, 1, 0]], np.float32)))

        self.imu: List[Tuple[float, np.ndarray, np.ndarray]] = []
        imu_path = os.path.join(root, "imu.txt")
        if use_imu and os.path.exists(imu_path):
            with open(imu_path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    vals = [float(v) for v in line.replace(",", " ").split()]
                    if len(vals) < 7:
                        continue
                    self.imu.append((vals[0], np.asarray(vals[1:4], np.float32),
                                     np.asarray(vals[4:7], np.float32)))

        g0 = _load_gray(os.path.join(root, self.pairs[0][1]))
        H, W = g0.shape
        fx, fy, cx, cy = self.CALIB
        sx, sy = W / 640.0, H / 480.0
        self.camera = C.CameraModel.make(fx * sx, fy * sy, cx * sx, cy * sy, W, H)
        self._first = g0

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[Frame]:
        j = k = m = 0
        prev_imu_cut = -np.inf
        for i, (stamp, rgb_rel, depth_rel) in enumerate(self.pairs):
            gray = self._first if i == 0 else _load_gray(os.path.join(self.root, rgb_rel))
            depth = _load_depth_png(os.path.join(self.root, depth_rel), self.depth_factor)
            pose = odom_pose = imu_batch = None
            if self.gt:
                j = _nearest(self.gt, j, stamp)
                if abs(self.gt[j][0] - stamp) < self.max_time_diff:
                    pose = self.gt[j][1]
            if self.odom:
                k = _nearest(self.odom, k, stamp)
                if abs(self.odom[k][0] - stamp) < self.max_time_diff:
                    odom_pose = self.odom[k][1]
            if self.imu:
                imu_batch = []
                while m < len(self.imu) and self.imu[m][0] <= stamp:
                    if self.imu[m][0] > prev_imu_cut:
                        imu_batch.append(self.imu[m])
                    m += 1
                prev_imu_cut = stamp
            yield Frame(stamp=stamp, gray=gray, depth=depth, gt_pose=pose,
                        odom_pose=odom_pose, imu=imu_batch)

"""Trajectory export and import in the reference's five pose formats.

Port of ``rtabmap_tpu/tools/export_poses.py`` (the reference's
``graph::exportPoses`` / ``importPoses``): 0 = raw 3x4 rows, 1 = RGBD-SLAM
(TUM: stamp x y z qx qy qz qw), 2 = KITTI, 3 = TORO, 4 = g2o. Files are
host I/O: the pose conversions run on CPU tensors in float32, as the JAX
twin's do, so either package reads the other's files.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rtabmap_tpu_torch.geometry import transform as T


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _pose_quat(P):
    """(translation (3,), quaternion [x,y,z,w] (4,)) of one pose."""
    P = _t(P)
    return T.translation(P).numpy(), T.to_quaternion(P).numpy()


def export_poses(path: str, fmt: int, poses: Dict[int, np.ndarray],
                 stamps: Optional[Dict[int, float]] = None, links=None) -> None:
    ids = sorted(poses)
    with open(path, "w") as f:
        if fmt in (0, 2):  # raw / KITTI: 12 values a row
            for i in ids:
                f.write(" ".join(f"{v:.6f}" for v in np.asarray(poses[i]).reshape(-1)) + "\n")
        elif fmt == 1:  # RGBD-SLAM / TUM
            for i in ids:
                t, q = _pose_quat(poses[i])
                stamp = (stamps or {}).get(i, float(i))
                f.write(f"{stamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
        elif fmt == 3:  # TORO
            for i in ids:
                v = T.to_xyzrpy(_t(poses[i])).numpy()
                f.write(f"VERTEX3 {i} " + " ".join(f"{x:.6f}" for x in v) + "\n")
            for lk in links or []:
                v = T.to_xyzrpy(_t(lk.transform)).numpy()
                f.write(f"EDGE3 {lk.from_id} {lk.to_id} "
                        + " ".join(f"{x:.6f}" for x in v) + "\n")
        elif fmt == 4:  # g2o
            for i in ids:
                t, q = _pose_quat(poses[i])
                f.write(f"VERTEX_SE3:QUAT {i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
            for lk in links or []:
                t, q = _pose_quat(lk.transform)
                info = np.asarray(lk.information)
                upper = " ".join(f"{info[r, c]:.6f}" for r in range(6) for c in range(r, 6))
                f.write(f"EDGE_SE3:QUAT {lk.from_id} {lk.to_id} "
                        f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {upper}\n")
        else:
            raise ValueError(f"unknown format {fmt}")


def import_poses(path: str, fmt: int) -> Dict[int, np.ndarray]:
    poses: Dict[int, np.ndarray] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    if fmt in (0, 2):
        for i, line in enumerate(lines):
            poses[i] = np.asarray([float(x) for x in line.split()], np.float32).reshape(3, 4)
    elif fmt == 1:
        for i, line in enumerate(lines):
            v = [float(x) for x in line.split()]
            poses[i] = T.from_quaternion(_t(v[4:8]), _t(v[1:4])).numpy()
    elif fmt == 3:
        for line in lines:
            parts = line.split()
            if parts[0] == "VERTEX3":
                poses[int(parts[1])] = T.from_xyzrpy(
                    _t([float(x) for x in parts[2:8]])).numpy()
    elif fmt == 4:
        for line in lines:
            parts = line.split()
            if parts[0] == "VERTEX_SE3:QUAT":
                t = _t([float(x) for x in parts[2:5]])
                q = _t([float(x) for x in parts[5:9]])
                poses[int(parts[1])] = T.from_quaternion(q, t).numpy()
    else:
        raise ValueError(f"unknown format {fmt}")
    return poses

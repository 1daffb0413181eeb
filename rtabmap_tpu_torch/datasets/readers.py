"""Dataset frame records.

Port of the ``Frame`` record of ``rtabmap_tpu/datasets/readers.py``: one
stamped camera frame (gray image, depth or right image, optional ground
truth, external odometry and IMU samples), host-side, and beside the
twin's fields the node's laser scan and local occupancy grid for
``Rtabmap.process`` (``tools/rgbd_scan.py`` fills them). The TUM RGB-D,
KITTI and EuRoC readers come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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

"""Frame-level features and the ``Kp/DetectorStrategy`` dispatch.

Port of ``rtabmap_tpu/core/frame.py``: ``FrameFeatures`` (fixed-K struct
of tensors, the unit of quantization), ``SensorData``, ``EnvSensor``,
``extract_features`` (with the sign-LSH binarisation of float
descriptors) and ``FeatureExtractor``: every classical strategy of
``CLASSICAL_STRATEGIES`` and the learned SuperPoint strategies (11, 15,
16).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import features as F


class EnvSensor(NamedTuple):
    """Environmental sensor reading attached to a node (reference:
    ``EnvSensor`` on SensorData), stored per node by ``memory/db.py``."""

    type: int      # one of ENV_SENSOR_* below
    value: float
    stamp: float = 0.0


ENV_SENSOR_UNDEFINED = 0
ENV_SENSOR_WIFI_SIGNAL_STRENGTH = 1    # dBm
ENV_SENSOR_AMBIENT_TEMPERATURE = 2     # celsius
ENV_SENSOR_AMBIENT_AIR_PRESSURE = 3    # hPa
ENV_SENSOR_AMBIENT_LIGHT = 4           # lx
ENV_SENSOR_AMBIENT_RELATIVE_HUMIDITY = 5  # %
ENV_SENSOR_CUSTOM1 = 6


class SensorData(NamedTuple):
    """One input frame (host-side container; arrays may be numpy or tensors)."""

    gray: object             # (H,W) float32 [0,1]
    depth: Optional[object]  # (H,W) metres, 0 = invalid; None for stereo
    right: Optional[object]  # (H,W) right image of a stereo pair; None for RGB-D
    stamp: float = 0.0
    id: int = 0


class FrameFeatures(NamedTuple):
    """Fixed-K per-frame features."""

    uv: torch.Tensor        # (K,2) pixel coords
    desc: torch.Tensor      # (K,D) +-1 int8 descriptors (0 rows = invalid)
    pts3d: torch.Tensor     # (K,3) camera-frame 3D (0 where invalid)
    valid: torch.Tensor     # (K,) keypoint validity
    valid3d: torch.Tensor   # (K,) has valid depth/3D
    angle: torch.Tensor     # (K,)
    response: torch.Tensor  # (K,)

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


# The 256 sign-LSH hyperplanes of float descriptors: the JAX twin's
# jax.random.normal(PRNGKey(0), (128, 256)), shipped as float32 (written by
# scripts/write_sift_lsh.py, held to a fresh draw by tests/test_torch_sift_lsh.py).
_LSH_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sift_lsh.npy")
_LSH_HOST = []
_LSH_DEV = {}


def lsh_planes(device) -> torch.Tensor:
    """The (128, 256) float32 sign-LSH hyperplanes on ``device``."""
    if not _LSH_HOST:
        _LSH_HOST.append(np.load(_LSH_PATH))
    return F._on_device(_LSH_DEV, _LSH_HOST[0], torch.device(device))


def lsh_binarize(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K,128) float descriptors -> (K,256) +-1 int8 sign-LSH words: the
    rows normalised, ``x @ R >= 0``, invalid rows zeroed."""
    x = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
    bits = torch.where(x @ lsh_planes(desc.device) >= 0, 1, -1).to(torch.int8)
    return torch.where(valid[:, None], bits, torch.zeros_like(bits))


def extract_features(gray: torch.Tensor, depth: torch.Tensor, cam: C.CameraModel,
                     max_kp: int = 512, min_depth: float = 0.1,
                     max_depth: float = 20.0, use_grid: bool = True,
                     detector: str = "gftt", descriptor: str = "brief") -> FrameFeatures:
    """Detect + describe + 3D-from-depth in one pass. A float descriptor
    (``descriptor="sift"``) is binarised by 256-bit sign-LSH (fixed random
    hyperplanes on the unit sphere, cosine-preserving), so every strategy
    feeds the same +-1 int8 Hamming vocabulary and matching."""
    kps, desc = F.detect_and_describe(gray, max_kp, use_grid=use_grid,
                                      detector=detector, descriptor=descriptor)
    if desc.dtype != torch.int8:
        desc = lsh_binarize(desc, kps.valid)
    pts3d, ok3d = F.keypoints_3d_from_depth(kps, depth, cam, min_depth, max_depth)
    return FrameFeatures(uv=kps.uv, desc=desc, pts3d=pts3d, valid=kps.valid,
                         valid3d=ok3d, angle=kps.angle, response=kps.response)


# Kp/DetectorStrategy -> (response map, descriptor), as in the JAX package.
CLASSICAL_STRATEGIES = {
    0: ("dog", "brief"),   # SURF -> blob detector + binary descriptor
    1: ("dog", "sift"),    # SIFT
    2: ("fast", "brief"),  # ORB = FAST + rotated BRIEF
    3: ("fast", "brief"),  # FAST/FREAK
    4: ("fast", "brief"),  # FAST/BRIEF
    5: ("gftt", "brief"),  # GFTT/FREAK
    6: ("gftt", "brief"),  # GFTT/BRIEF (the reference default)
    7: ("fast", "brief"),  # BRISK
    8: ("gftt", "brief"),  # GFTT/ORB
    9: ("dog", "sift"),    # KAZE
    10: ("gftt", "brief"),  # ORB-OCTREE (grid-balanced top-k)
    12: ("dog", "brief"),  # SURF/FREAK
    13: ("gftt", "brief"),  # GFTT/DAISY
    14: ("dog", "brief"),  # SURF/DAISY
}
LEARNED_STRATEGIES = (11, 15, 16)  # SuperPoint / PyDetector / SP-rpautrat


class FeatureExtractor:
    """``Kp/DetectorStrategy`` dispatch (the reference's ``Feature2D::create``).
    Strategies 11, 15 and 16 run SuperPoint (``models/superpoint.py``: the
    bundled weights, or ``SuperPoint/ModelPath``, an npz of either package),
    with ``SuperPoint/Threshold`` (``SuperPointRpautrat/Threshold`` for 16)
    and ``SuperPoint/NMS`` / ``NMSRadius``; the others run the classical
    pipeline. ``extract(gray, depth) -> (FrameFeatures, descf)``: descf is
    the (K, 256) float descriptor table of the learned strategies (for the
    ``Vis/CorNNType`` 6 matcher, through ``Rtabmap.process(descf=...)``) and
    None for the classical ones. Inputs are moved to ``device`` (None = the
    CUDA card)."""

    def __init__(self, cam: C.CameraModel, params=None, max_kp: int = 512,
                 min_depth: float = 0.1, max_depth: float = 20.0,
                 device: DeviceLike = None):
        from rtabmap_tpu_torch.utils.params import Parameters

        p = params or Parameters()
        self.device = resolve_device(device)
        self.cam = cam
        self.max_kp = max_kp
        self.strategy = int(p["Kp/DetectorStrategy"])
        self.min_depth, self.max_depth = min_depth, max_depth
        if self.learned:
            from rtabmap_tpu_torch.models.superpoint import SuperPoint

            model_path = str(p["SuperPoint/ModelPath"] or "")
            self._sp = (SuperPoint.load_params(model_path, device=self.device) if model_path
                        else SuperPoint.distilled(device=self.device))
            thr_key = ("SuperPointRpautrat/Threshold" if self.strategy == 16
                       else "SuperPoint/Threshold")
            self._sp_threshold = float(p[thr_key])
            self._sp_nms = (2 * int(p["SuperPoint/NMSRadius"]) + 1
                            if bool(p["SuperPoint/NMS"]) else 1)
            return
        self.detector, self.descriptor = CLASSICAL_STRATEGIES.get(
            self.strategy, ("gftt", "brief"))

    @property
    def learned(self) -> bool:
        return self.strategy in LEARNED_STRATEGIES

    def _image(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.array(img, np.float32)).to(self.device)

    def extract_superpoint(self, gray: torch.Tensor):
        """SuperPoint on one image -> (Keypoints, desc, descf)."""
        return self._sp.extract(gray, self.max_kp, nms_size=self._sp_nms,
                                conf_threshold=self._sp_threshold)

    def extract(self, gray, depth=None):
        gray = self._image(gray)
        depth = torch.zeros_like(gray) if depth is None else self._image(depth)
        if not self.learned:
            fr = extract_features(gray, depth, self.cam, self.max_kp,
                                  self.min_depth, self.max_depth,
                                  detector=self.detector, descriptor=self.descriptor)
            return fr, None
        kps, desc, descf = self.extract_superpoint(gray)
        pts3d, ok3d = F.keypoints_3d_from_depth(kps, depth, self.cam, self.min_depth,
                                                self.max_depth)
        fr = FrameFeatures(uv=kps.uv, desc=desc, pts3d=pts3d, valid=kps.valid,
                           valid3d=ok3d, angle=kps.angle, response=kps.response)
        return fr, descf

    def __call__(self, gray, depth=None):
        return self.extract(gray, depth)

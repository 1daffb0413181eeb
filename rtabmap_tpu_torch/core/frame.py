"""Frame-level features and the ``Kp/DetectorStrategy`` dispatch.

Port of ``rtabmap_tpu/core/frame.py`` for the classical GFTT/BRIEF path:
``FrameFeatures`` (fixed-K struct of tensors, the unit of quantization),
``extract_features`` and ``FeatureExtractor``. Strategies whose detector
or descriptor is not ported yet, and the learned strategies, raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import features as F


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


def extract_features(gray: torch.Tensor, depth: torch.Tensor, cam: C.CameraModel,
                     max_kp: int = 512, min_depth: float = 0.1,
                     max_depth: float = 20.0, use_grid: bool = True,
                     detector: str = "gftt", descriptor: str = "brief") -> FrameFeatures:
    """Detect + describe + 3D-from-depth in one pass."""
    kps, desc = F.detect_and_describe(gray, max_kp, use_grid=use_grid,
                                      detector=detector, descriptor=descriptor)
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
PORTED = ("gftt", "brief")


class FeatureExtractor:
    """``Kp/DetectorStrategy`` dispatch over the classical pipeline.
    ``extract(gray, depth) -> (FrameFeatures, None)``; inputs are moved to
    ``device`` (None = the CUDA card)."""

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
        if self.strategy in LEARNED_STRATEGIES:
            raise NotImplementedError(
                f"Kp/DetectorStrategy={self.strategy} (learned SuperPoint) is "
                "not ported yet; it comes with the learned-front-end slice")
        self.detector, self.descriptor = CLASSICAL_STRATEGIES.get(
            self.strategy, PORTED)
        if (self.detector, self.descriptor) != PORTED:
            raise NotImplementedError(
                f"Kp/DetectorStrategy={self.strategy} needs the "
                f"{self.detector}/{self.descriptor} pipeline, which comes with "
                "a later slice; only GFTT/BRIEF strategies are ported")

    def _image(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.array(img, np.float32)).to(self.device)

    def extract(self, gray, depth=None):
        gray = self._image(gray)
        depth = torch.zeros_like(gray) if depth is None else self._image(depth)
        fr = extract_features(gray, depth, self.cam, self.max_kp,
                              self.min_depth, self.max_depth,
                              detector=self.detector, descriptor=self.descriptor)
        return fr, None

    def __call__(self, gray, depth=None):
        return self.extract(gray, depth)

"""Odometry strategy factory.

Port of ``rtabmap_tpu/odometry/__init__.py``: the reference's
``Odometry::create`` switch (``Odom/Strategy`` selects F2M/F2F/Mono or one
of the external-library wrappers), with its ``Reg/Strategy`` = 1 (ICP)
dispatch to the scan-to-map odometry: the native ``f2m`` (visual
frame-to-map, the default), ``f2f`` (frame to keyframe), ``mono`` and
``scan_f2m``. The external wrappers raise as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from rtabmap_tpu_torch.odometry.f2f import OdometryF2F
from rtabmap_tpu_torch.odometry.f2m import OdometryF2M
from rtabmap_tpu_torch.odometry.mono import OdometryMono
from rtabmap_tpu_torch.odometry.scan_f2m import OdometryScanF2M
from rtabmap_tpu_torch.utils.params import Parameters

# reference Odom/Strategy numbering (Parameters.h: 0=F2M 1=F2F ... 12=Open3D)
_STRATEGIES: Dict[int, str] = {
    0: "f2m", 1: "f2f", 2: "fovis", 3: "viso2", 4: "dvo", 5: "orbslam",
    6: "okvis", 7: "loam", 8: "msckf", 9: "vins", 10: "openvins",
    11: "floam", 12: "open3d",
}

_EXTERNAL = {name for i, name in _STRATEGIES.items() if i >= 2}

def _external_stub(name: str) -> Callable:
    def make(*a, **kw):
        raise RuntimeError(
            f"odometry strategy '{name}' wraps an external library "
            f"(reference: corelib/src/odometry/Odometry{name.capitalize()}.cpp) "
            f"and is not available; use one of {sorted(set(_REGISTRY) - _EXTERNAL)}")
    return make


_REGISTRY: Dict[str, Callable] = {
    "f2m": OdometryF2M,
    "f2f": OdometryF2F,
    "mono": OdometryMono,
    # the reference reaches scan/ICP odometry through OdometryF2M + Reg/Strategy=1
    "scan_f2m": OdometryScanF2M,
}
_REGISTRY.update({n: _external_stub(n) for n in _EXTERNAL})


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def create_odometry(cam, params=None, **kwargs):
    """Factory honouring ``Odom/Strategy`` (int, reference numbering) or a
    strategy name in ``kwargs['strategy']``; other kwargs (``device``, ...)
    go to the strategy."""
    strategy = kwargs.pop("strategy", None)
    if strategy is None:
        p = params or Parameters()
        strategy = _STRATEGIES.get(int(p["Odom/Strategy"]), "f2m")
        # Registration::create in the reference's Odometry constructor
        if strategy == "f2m" and int(p["Reg/Strategy"]) == 1:
            strategy = "scan_f2m"
    if isinstance(strategy, int):
        strategy = _STRATEGIES.get(strategy, "f2m")
    if strategy not in _REGISTRY:
        raise KeyError(f"unknown odometry strategy '{strategy}'; "
                       f"available: {available_strategies()}")
    return _REGISTRY[strategy](cam, params, **kwargs)

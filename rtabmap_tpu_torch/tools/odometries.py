"""Synthetic runs of the frame-to-keyframe and the monocular odometries.

Renders frames of the synthetic room, extracts each frame's features
(``FeatureExtractor``, ``Kp/DetectorStrategy`` 6 = GFTT/BRIEF by default)
and tracks them with the odometry that ``create_odometry`` builds:

- ``f2f`` (``Odom/Strategy`` 1): the first lap of ``rgbd_laps``' ``full``
  sequence (``loop_trajectory(60)`` at 640x480, fx = fy = 500, 512
  keypoints, in the doubled hall ``rgbd_laps.FULL_WORLD``), RGB-D;
- ``mono`` (``create_odometry(strategy="mono")``): the lateral strafe of
  ``tests/test_odometry_mono.py`` (0.06 m a frame along x, a 0.004 rad
  yaw a frame) at 640x480 with fx = fy = 640 (its 160x120 camera scaled
  4x), 512 keypoints, the grays only, ``OdomMono/InitMinFlow`` 8 and
  ``Vis/MinInliers`` 12 as that test sets them.

Prints one JSON line a run: frames, lost frames (for mono, frames without
a pose after initialisation), the odometry ATE against the ground truth
(F2F: rigidly aligned; mono: Sim(3)-aligned, with the trajectory's span
and the RMSE's share of it), and the median / p90 host times of the
extraction and the odometry. ``scripts/jax_odometries.py`` runs the same
frames through the JAX package; ``chip_smoke.py`` holds the card's runs
to it.

Usage: python -m rtabmap_tpu_torch.tools.odometries [--device cpu]
       [--run f2f mono] [--frames N] [--seed S] [--size W H]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.utils.params import Parameters

RUNS = ("f2f", "mono")
MONO_PARAMS = {"OdomMono/InitMinFlow": 8.0, "Vis/MinInliers": 12}
MONO_FRAMES = 20        # tests/test_odometry_mono.py's length


def strafe_trajectory(n: int, step: float = 0.06, yaw_per_step: float = 0.004) -> np.ndarray:
    """tests/test_odometry_mono.py's lateral dolly along x with a slight
    yaw (rotation about the camera's y axis): (n,3,4) camera-in-world."""
    poses = []
    for i in range(n):
        a = yaw_per_step * i
        c, s = np.cos(np.float32(a)), np.sin(np.float32(a))
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
        poses.append(np.concatenate([R, np.array([[step * i], [0.0], [0.0]], np.float32)],
                                    axis=1))
    return np.stack(poses).astype(np.float32)


def run_spec(name: str, frames: int = 0, size: Optional[Tuple[int, int]] = None) -> Dict:
    """Camera, poses, world, keypoints and parameters of a run; ``size``
    scales the camera (fx with the width)."""
    from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD, loop_trajectory
    from rtabmap_tpu_torch.tools.rgbd_laps import FULL_WORLD

    W, H = size or (640, 480)
    if name == "f2f":
        spec = {"poses": loop_trajectory(60), "f": 500.0 * W / 640, "world": FULL_WORLD,
                "params": {"Odom/Strategy": 1}, "depth": True}
    elif name == "mono":
        spec = {"poses": strafe_trajectory(MONO_FRAMES), "f": 640.0 * W / 640,
                "world": DEFAULT_WORLD.half_extent, "params": dict(MONO_PARAMS),
                "depth": False}
    else:
        raise KeyError(f"unknown run {name!r}; use one of {RUNS}")
    if frames:
        spec["poses"] = spec["poses"][:frames]
    spec.update(size=(W, H), c=((W - 1) / 2.0, (H - 1) / 2.0), max_kp=512)
    return spec


def _ms(x) -> Dict:
    return ({"median": float(np.median(x)), "p90": float(np.percentile(x, 90))}
            if len(x) else {"median": 0.0, "p90": 0.0})


def summarize(name: str, est: Dict[int, np.ndarray], gt: np.ndarray, times: Dict) -> Dict:
    """Lost frames and the odometry ATE of a run (``est``: frame index ->
    pose of the frames that got one)."""
    from rtabmap_tpu_torch.utils import metrics

    idx = sorted(est)
    out = {"run": name, "frames": len(gt), "tracked": len(idx),
           "extract_ms": _ms(times["extract_ms"]), "odom_ms": _ms(times["odom_ms"])}
    if name == "mono":
        first = idx[0] if idx else len(gt)
        out["initialized_at"] = first if idx else None
        out["lost"] = len(gt) - first - len(idx)
    else:
        out["lost"] = len(gt) - len(idx)
    if len(idx) >= 3:
        e = np.stack([est[i] for i in idx])
        g = gt[idx]
        out["ate_odom"] = metrics.ate_rmse(e, g, with_scale=(name == "mono"))
        span = float(np.linalg.norm(g[:, :, 3].max(0) - g[:, :, 3].min(0)))
        out["span"] = span
        out["ate_share_of_span"] = out["ate_odom"] / max(span, 1e-9)
    return out


def run_odometry(name: str, device: DeviceLike = None, frames: int = 0, seed: int = 0,
                 size: Optional[Tuple[int, int]] = None) -> Dict:
    """Render the run on ``device`` (None = the CUDA card), extract and
    track every frame; ``seed`` seeds the odometry's RANSAC generator.
    Returns the summary with the raw poses under ``"est"``."""
    import torch

    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.datasets.synthetic import World, render_sequence
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.odometry import create_odometry

    dev = resolve_device(device)
    spec = run_spec(name, frames, size)
    W, H = spec["size"]
    cam = C.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    params = Parameters(spec["params"])
    grays, depths = render_sequence(spec["poses"], cam, World(spec["world"], 0), device=dev)
    fe = FeatureExtractor(cam, params, max_kp=spec["max_kp"], device=dev)
    odom = create_odometry(cam, params, strategy=None if name == "f2f" else "mono",
                           seed=seed, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {"extract_ms": [], "odom_ms": []}
    est = {}
    for i in range(len(spec["poses"])):
        t = time.perf_counter()
        feat, _ = fe.extract(grays[i], depths[i] if spec["depth"] else None)
        sync()
        times["extract_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        pose, _, _ = odom.process(feat)
        if pose is not None:
            est[i] = pose.cpu().numpy()
        times["odom_ms"].append((time.perf_counter() - t) * 1e3)
    out = summarize(name, est, spec["poses"], times)
    out["est"] = est
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--run", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--frames", type=int, default=0, help="cut each run (0 = whole)")
    ap.add_argument("--seed", type=int, default=0, help="the odometry's RANSAC seed")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("W", "H"))
    args = ap.parse_args(argv)
    for name in args.run:
        out = run_odometry(name, args.device, args.frames, args.seed,
                           tuple(args.size) if args.size else None)
        out.pop("est")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

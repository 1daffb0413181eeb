"""Two-lap synthetic BOWMapping run of the appearance-only tick.

Renders the synthetic room along ``loop_trajectory`` twice — lap 2 at
radius 1.45 m and height 0.05 m, so no frame repeats exactly — and feeds
every frame through ``FeatureExtractor.extract`` -> ``Rtabmap.process``
with RGBD/Enabled=false. Lap-2 closures are scored against the lap-1
frames of the same viewpoint. ``chip_smoke.py`` drives this at 640x480
with 400 keypoints, the default 262144-word vocabulary and 1024 node
slots; ``scripts/jax_bow_laps.py`` runs the same sequence through the JAX
package.

Usage: python -m rtabmap_tpu_torch.tools.bow_laps [--device cpu]
       [--frames-per-lap 150] [--size 640 480] [--profile]

``--profile`` traces lap 2 with ``torch.profiler`` and prints the device
time by kernel and the device's busy share of the lap's wall time.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FeatureExtractor
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.utils.logging import Statistics
from rtabmap_tpu_torch.utils.params import Parameters

FRAMES_PER_LAP = 150


def lap_poses(n: int) -> np.ndarray:
    """(2n,3,4) poses: lap 1 then lap 2, viewpoint i of each lap alike."""
    return np.concatenate([loop_trajectory(n), loop_trajectory(n, radius=1.45, height=0.05)])


def same_view_closures(closures, node_frames, n: int, window: int = 3) -> int:
    """Lap-2 closures (tick, node) whose node covers a lap-1 frame within
    ``window`` frames (circularly) of the tick's own viewpoint."""
    hits = 0
    for i, lc in closures:
        view = i - n
        frames = [f for f in node_frames.get(lc, ()) if f < n]
        if any(min(abs(f - view), n - abs(f - view)) <= window for f in frames):
            hits += 1
    return hits


@dataclass
class LapRun:
    slam: Rtabmap
    n: int
    tick_ms: List[float] = field(default_factory=list)
    stats: List[Statistics] = field(default_factory=list)
    closures: List[Tuple[int, int]] = field(default_factory=list)
    node_frames: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def lap2_closures(self) -> List[Tuple[int, int]]:
        return [(i, lc) for i, lc in self.closures if i >= self.n]

    @property
    def lap2_same_view(self) -> int:
        return same_view_closures(self.lap2_closures, self.node_frames, self.n)

    def summary(self) -> dict:
        timing = {}
        for k in sorted({k for s in self.stats for k in s.data if k.startswith("Timing")}):
            timing[k] = float(np.median([s.data[k] for s in self.stats if k in s.data]))
        mem = self.slam.memory
        return {"frames": len(self.tick_ms),
                "tick_ms_median": float(np.median(self.tick_ms)),
                "tick_ms_p90": float(np.percentile(self.tick_ms, 90)),
                "tick_ms_lap2_median": float(np.median(self.tick_ms[self.n:])),
                "closures": len(self.closures), "lap2_closures": len(self.lap2_closures),
                "lap2_same_view": self.lap2_same_view, "n_words": mem.vocab.n_words,
                "nodes": len(mem.signatures), "wm": len(mem.wm),
                "timing_median_ms": timing}


def run(device: DeviceLike = None, frames_per_lap: int = FRAMES_PER_LAP,
        size=(640, 480), max_kp: int = 400, node_capacity: int = 1024,
        params: Optional[Parameters] = None, before_lap2=None, after_lap2=None) -> LapRun:
    """Render both laps on ``device``, then run the ticks. The tick time is
    extraction + ``process`` up to a device synchronize. ``before_lap2`` /
    ``after_lap2`` are called around the second lap (e.g. a profiler)."""
    dev = resolve_device(device)
    W, H = size
    n = frames_per_lap
    cam = C.CameraModel.make(500.0, 500.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    p = params or Parameters()
    p.set("RGBD/Enabled", False)
    slam = Rtabmap(cam, p, node_capacity=node_capacity, words_per_frame=max_kp, device=dev)
    fe = FeatureExtractor(cam, p, max_kp=max_kp, device=dev)
    poses = lap_poses(n)
    grays = [render(pose, cam, device=dev)[0] for pose in poses]
    out = LapRun(slam=slam, n=n)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    for i, (pose, gray) in enumerate(zip(poses, grays)):
        if i == n and before_lap2 is not None:
            before_lap2()
        t0 = time.perf_counter()
        fr, _ = fe.extract(gray)
        st = slam.process(fr, pose, stamp=float(i))
        sync()
        out.tick_ms.append((time.perf_counter() - t0) * 1e3)
        out.stats.append(st)
        out.node_frames.setdefault(st.ref_id, []).append(i)
        if st.loop_closure_id:
            out.closures.append((i, int(st.loop_closure_id)))
    if after_lap2 is not None:
        after_lap2()
    return out


def _device_busy_us(prof) -> Tuple[float, int]:
    """(union of the traced device intervals in us, their count): kernels
    and copies alike."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0, 0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, len(spans)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames-per-lap", type=int, default=FRAMES_PER_LAP)
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    prof, window = None, {}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def start():
            prof.__enter__()  # the profiler's own start-up stays out of the window
            window["t0"] = time.perf_counter()

        def stop():
            # the lap's last tick ended in a synchronize: all its device work is done
            window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.__exit__(None, None, None)
    res = run(args.device, args.frames_per_lap, tuple(args.size),
              before_lap2=start if prof else None, after_lap2=stop if prof else None)
    summary = res.summary()
    if prof is not None:
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
        busy_us, n_device_ops = _device_busy_us(prof)
        summary["profile_lap2"] = {
            "ticks": args.frames_per_lap,
            "wall_ms": window["wall_us"] / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / window["wall_us"],
            "device_ops_per_tick": n_device_ops / args.frames_per_lap}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

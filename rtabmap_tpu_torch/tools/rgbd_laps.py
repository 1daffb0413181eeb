"""Synthetic RGB-D SLAM runs of the default metric tick.

Renders the synthetic value-noise room and feeds every frame through
``run_dataset`` (``FeatureExtractor.extract`` -> ``OdometryF2M.process``
-> ``Rtabmap.process`` with the default parameters: ``RGBD/Enabled`` true,
F2M visual odometry, PnP registration, proximity closures, incremental
graph optimization). The sequences:

- ``parity``: the JAX package's end-to-end test sequence
  (``tests/test_slam_e2e.py``): ``loop_trajectory(48)`` then its first 10
  poses again, 320x240, fx = fy = 300, 384 keypoints, 128 node slots;
- ``full``: a TUM RGB-D-sized camera, 640x480, fx = fy = 500, two laps
  (``loop_trajectory(60)``, then the same loop at radius 1.45 m and height
  0.05 m, so no frame repeats exactly), 512 keypoints, the default
  262144-word vocabulary, 1024 node slots, the 2000-point F2M map and
  local bundle adjustment, in a room twice the default size
  (``FULL_WORLD``);
- ``full-default-room``: the same in the default room, where the odometry
  loses track (kept to show it);
- ``full-revisit``: ``full``'s camera, room and sizes, its second lap
  repeating the first exactly (exact revisits).

``--learned`` runs the learned front end (``Kp/DetectorStrategy`` 11,
SuperPoint, and ``Vis/CorNNType`` 6, the bundled attentional matcher).
``--strategy N`` sets ``Kp/DetectorStrategy`` N (a classical front end:
e.g. 1 SIFT, whose float descriptors become sign-LSH words, or 2 ORB,
FAST + rotated BRIEF) and ``--cor-nn-type N`` sets ``Vis/CorNNType`` N
(7: GMS-filtered matches in the engine's registrations).
``--gt-odometry`` skips the odometry: each frame's features and its
ground-truth pose go straight into ``Rtabmap.process`` (the loop of
``tests/test_learned_stack.py``); the summary then adds each frame's
highest hypothesis id and value.

``scripts/jax_rgbd_laps.py`` runs the same sequences through the JAX
package; ``chip_smoke.py`` holds the port's runs on the card to it.

Usage: python -m rtabmap_tpu_torch.tools.rgbd_laps [--device cpu]
       [--sequence parity|full|full-default-room|full-revisit] [--frames N]
       [--seed S] [--learned | --strategy N] [--cor-nn-type N] [--gt-odometry]
       [--profile N] [--trace-dir DIR]

``--profile N`` traces the last N frames with ``torch.profiler`` and
prints the device's busy share, device operations a frame and the top
device operations. ``--trace-dir DIR`` traces the whole run the way the
dataset tools do (``Tpu/ProfileDir``: ``run_dataset`` writes the trace
into DIR) and adds the trace's file and busy share to the summary; it
goes with neither ``--gt-odometry`` nor ``--profile``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

from rtabmap_tpu_torch.datasets.readers import Frame
from rtabmap_tpu_torch.datasets.synthetic import (
    DEFAULT_WORLD, World, loop_trajectory, render_sequence,
)
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.memory import LINK_GLOBAL_CLOSURE, LINK_LOCAL_SPACE_CLOSURE
from rtabmap_tpu_torch.tools.dataset_runner import run_dataset
from rtabmap_tpu_torch.utils import metrics
from rtabmap_tpu_torch.utils.logging import device_busy_us
from rtabmap_tpu_torch.utils.params import Parameters


# The full-width sequence's room: the default room doubled in each
# dimension, a 16 x 12 x 16 m hall, so the walls are 6.5-10 m away. In the
# default 8 x 6 x 8 m room ("full-default-room") the walls 2-4 m away show
# the value-noise texture too coarsely at 640x480 and fx = 500: GFTT keeps
# few corners in the views toward one corner of the room, and the F2M
# odometry (the JAX package's as well) loses track there for good.
FULL_WORLD = (8.0, 6.0, 8.0)
SEQUENCES = ("parity", "full", "full-default-room", "full-revisit")
# the learned front end: SuperPoint features, the attentional matcher
LEARNED = {"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6}


def front_end_params(learned: bool = False, strategy: Optional[int] = None,
                     cor_nn_type: Optional[int] = None) -> Parameters:
    """The parameters of a run: the learned front end, or the
    ``Kp/DetectorStrategy`` and ``Vis/CorNNType`` given, over the
    defaults."""
    p = Parameters(LEARNED if learned else {})
    if strategy is not None:
        p.set("Kp/DetectorStrategy", strategy)
    if cor_nn_type is not None:
        p.set("Vis/CorNNType", cor_nn_type)
    return p


def sequence_spec(name: str) -> Dict:
    """Camera, poses and sizes of one of the two sequences."""
    if name == "parity":
        poses = np.concatenate([loop_trajectory(48), loop_trajectory(48)[:10]])
        return {"size": (320, 240), "f": 300.0, "c": (160.0, 120.0), "poses": poses,
                "max_kp": 384, "node_capacity": 128, "world": DEFAULT_WORLD.half_extent}
    if name in ("full", "full-default-room", "full-revisit"):
        lap2 = (loop_trajectory(60) if name == "full-revisit"
                else loop_trajectory(60, radius=1.45, height=0.05))
        poses = np.concatenate([loop_trajectory(60), lap2])
        world = DEFAULT_WORLD.half_extent if name == "full-default-room" else FULL_WORLD
        return {"size": (640, 480), "f": 500.0, "c": (319.5, 239.5), "poses": poses,
                "max_kp": 512, "node_capacity": 1024, "world": world}
    raise KeyError(f"unknown sequence {name!r}; use one of {SEQUENCES}")


def run_sequence(name: str, device: DeviceLike = None, frames: int = 0,
                 params: Optional[Parameters] = None, on_frame=None, seed: int = 0,
                 gt_odometry: bool = False) -> Dict:
    """Render the sequence on ``device`` (None = the CUDA card) and run it
    through ``run_dataset``, or with ``gt_odometry`` through
    ``run_gt_odometry``. ``on_frame(i)`` is called right before frame i
    is handed over (e.g. to start a profiler; every earlier frame ended in
    a device synchronize). Returns the summary (see ``summary``) with the
    raw run under ``"run"``."""
    dev = resolve_device(device)
    spec = sequence_spec(name)
    poses = spec["poses"][:frames] if frames else spec["poses"]
    W, H = spec["size"]
    cam = C.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    grays, depths = render_sequence(poses, cam, World(spec["world"], DEFAULT_WORLD.seed),
                                    device=dev)

    def stream():
        for i, (pose, gray, depth) in enumerate(zip(poses, grays, depths)):
            if on_frame is not None:
                on_frame(i)
            yield Frame(stamp=float(i), gray=gray, depth=depth, gt_pose=pose)

    runner = run_gt_odometry if gt_odometry else run_dataset
    run = runner(stream(), cam, params or Parameters(), max_kp=spec["max_kp"],
                 node_capacity=spec["node_capacity"], verbose=False, device=dev, seed=seed)
    return summary(run, poses)


def run_gt_odometry(frames, cam, params: Parameters, max_kp: int = 512,
                    node_capacity: int = 1024, verbose: bool = False,
                    device: DeviceLike = None, seed: int = 0) -> Dict:
    """Each frame's features (``FeatureExtractor.extract``, with the float
    descriptors of a learned strategy) and its ground-truth pose straight
    into ``Rtabmap.process`` (covariance 1e-4, the engine's generator at
    42 + seed, as ``run_dataset`` seeds it). Returns ``run_dataset``'s
    keys that ``summary`` reads (no odometry: ``odom_ms`` 0, none lost)
    and each frame's highest hypothesis id and value."""
    import torch

    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap

    dev = resolve_device(device)
    fe = FeatureExtractor(cam, params, max_kp=max_kp, device=dev)
    slam = Rtabmap(cam, params, node_capacity=node_capacity, words_per_frame=max_kp,
                   seed=42 + seed, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {"extract_ms": [], "odom_ms": [], "process_ms": []}
    hyp_ids, hyp_values, gt = [], [], []
    loops = 0
    for i, fr in enumerate(frames):
        t = time.perf_counter()
        feat, descf = fe.extract(fr.gray, fr.depth)
        sync()
        times["extract_ms"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        st = slam.process(feat, fr.gt_pose, np.eye(6) * 1e-4, stamp=float(i),
                          gt_pose=fr.gt_pose, descf=descf)
        sync()
        times["process_ms"].append((time.perf_counter() - t) * 1e3)
        times["odom_ms"].append(0.0)
        loops += int(st.loop_closure_id > 0)
        hyp_ids.append(int(st.get("Loop/Highest hypothesis id/", 0)))
        hyp_values.append(float(st.get("Loop/Highest hypothesis value/", 0.0)))
        gt.append(np.asarray(fr.gt_pose, np.float32))
        if verbose:
            print(f"frame {i}: loop {st.loop_closure_id} hypothesis {hyp_ids[-1]} "
                  f"{hyp_values[-1]:.3f}")
    return {"frames": len(gt), "loops": loops, "lost": 0, "ate_odom": 0.0, "slam": slam,
            "hyp_ids": hyp_ids, "hyp_values": hyp_values, **times}


def closure_errors(slam) -> np.ndarray:
    """Translation error (m) of each loop and proximity closure link
    against the ground truth of its two nodes."""
    errs = []
    for i, s in slam.memory.signatures.items():
        for j, lk in s.links.items():
            o = slam.memory.get(j)
            if (i < j and lk.type in (LINK_GLOBAL_CLOSURE, LINK_LOCAL_SPACE_CLOSURE)
                    and s.gt_pose is not None and o is not None and o.gt_pose is not None):
                d = T.np_relative(T.np_relative(s.gt_pose, o.gt_pose), lk.transform)
                errs.append(T.np_translation_norm(d))
    return np.asarray(errs)


def summary(run: Dict, poses: np.ndarray) -> Dict:
    """Loop and proximity counts, lost frames, odometry (None under five
    frames) and SLAM ATE (each frame read at its node's optimized pose;
    frames whose node left the graph are left out, and counted), the closure links' errors against
    the ground truth, WM size and per-frame host times."""
    slam = run["slam"]
    hist = slam.stats_history
    opt = slam.get_optimized_poses()
    cerr = closure_errors(slam)
    have = [k for k, s in enumerate(hist) if s.ref_id in opt]
    est = np.stack([opt[hist[k].ref_id] for k in have])
    frame_ms = np.add(run["odom_ms"], run["process_ms"]) + np.asarray(run["extract_ms"])
    ms = lambda x: {"median": float(np.median(x)), "p90": float(np.percentile(x, 90))}  # noqa: E731
    extra = {k: run[k] for k in ("hyp_ids", "hyp_values") if k in run}
    mem = slam.memory
    return {**extra, "frames": run["frames"], "loops": run["loops"],
            "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
            "lost": run["lost"], "ate_odom": run.get("ate_odom"),
            "ate_slam": metrics.ate_rmse(est, poses[have]), "ate_slam_frames": len(have),
            "closure_links": int(cerr.size),
            "closure_err_max_m": float(cerr.max()) if cerr.size else 0.0,
            "closure_err_median_m": float(np.median(cerr)) if cerr.size else 0.0,
            "closure_err_over_10cm": int((cerr > 0.1).sum()),
            "optimized_poses": len(opt), "nodes": len(slam.memory.signatures),
            "wm": len(mem.wm), "n_words": mem.vocab.n_words,
            "quantize_calls": sum("TimingMem/Add new words/ms" in s.data for s in hist),
            "cor_nn_type": mem.cor_nn_type, "matcher_calls": mem.matcher_calls,
            "frame_ms": ms(frame_ms), "extract_ms": ms(run["extract_ms"]),
            "odom_ms": ms(run["odom_ms"]), "process_ms": ms(run["process_ms"]),
            "run": run}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--sequence", default="full", choices=SEQUENCES)
    ap.add_argument("--frames", type=int, default=0, help="cut the sequence (0 = whole)")
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC generators")
    ap.add_argument("--learned", action="store_true",
                    help="SuperPoint features and the attentional matcher")
    ap.add_argument("--strategy", type=int, default=None, metavar="N",
                    help="Kp/DetectorStrategy N (a classical front end)")
    ap.add_argument("--cor-nn-type", type=int, default=None, metavar="N",
                    help="Vis/CorNNType N (7: GMS)")
    ap.add_argument("--gt-odometry", action="store_true",
                    help="ground-truth poses into Rtabmap.process, no odometry")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the last N frames")
    ap.add_argument("--trace-dir", default="", metavar="DIR",
                    help="trace the whole run into DIR (Tpu/ProfileDir; not with "
                         "--gt-odometry or --profile)")
    args = ap.parse_args(argv)
    if args.learned and args.strategy is not None:
        ap.error("--learned sets the strategy: not with --strategy")
    params = front_end_params(args.learned, args.strategy, args.cor_nn_type)
    if args.trace_dir and (args.gt_odometry or args.profile):
        ap.error("--trace-dir traces run_dataset's run: not with --gt-odometry or --profile")
    if args.trace_dir:
        params.set("Tpu/ProfileDir", args.trace_dir)
    prof, window = None, {}
    n_total = args.frames or len(sequence_spec(args.sequence)["poses"])
    n = min(args.profile, n_total)
    if n:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def start(i):
            if i == n_total - n:
                prof.__enter__()  # the profiler's own start-up stays out of the window
                window["t0"] = time.perf_counter()
    out = run_sequence(args.sequence, args.device, args.frames,
                       params=params,
                       on_frame=start if prof else None, seed=args.seed,
                       gt_odometry=args.gt_odometry)
    if prof is not None:
        # run_dataset's last frame ended in a synchronize: the window is whole
        wall_us = (time.perf_counter() - window["t0"]) * 1e6
        prof.__exit__(None, None, None)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
        busy_us, n_device_ops = device_busy_us(prof)
        top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
        out["profile_last_frames"] = {
            "frames": n, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_ops_per_frame": n_device_ops / n,
            "top_device_ops_ms": {e.key: e.self_device_time_total / 1e3 for e in top}}
    run = out.pop("run")
    if "trace" in run:
        out["trace"] = run["trace"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Three RGB-D SLAM sessions against one map store: map, resume, localize.

The user path of the reference's persistent map (``memory/db.py``): a
robot maps a place and saves the map, later resumes mapping into the same
store, and later still localizes in it without changing it. Every frame
goes through ``run_dataset`` (``FeatureExtractor.extract`` ->
``OdometryF2M.process`` -> ``Rtabmap.process``, default parameters) at
the full width of ``rgbd_laps``' ``full`` sequence: 640x480, fx = fy =
500, 512 keypoints, the 262144-word vocabulary, 1024 node slots, in the
16 x 12 x 16 m hall (``rgbd_laps.FULL_WORLD``). The sessions, each
against the same store:

- ``mapping``: ``rgbd_laps``' ``full`` sequence (two 60-frame laps) into a
  fresh store, ``repair_graph()`` (see below), then ``close()``;
- ``resume``: ``Rtabmap.load(new_session=True)``, the odometry restarted
  at the identity, two more 85-frame laps at other radii and heights:
  the merged connected graph passes 256 nodes, so its full solves pad to
  512 nodes and run ``optimize_pcg``; then ``close()``;
- ``localization``: ``Rtabmap.load`` with ``Mem/IncrementalMemory``
  false, 20 frames of a lap between the mapped ones, the odometry started
  at the identity there.

The mapping session ends with ``repair_graph()``: a full solve of the
map, removing the closures that keep it above ``RGBD/OptimizeMaxError``.
The incremental (subgraph) solves can leave the whole map just past that
gate, and then every full solve that merges a resumed session is
rejected, while the
repair that repeated rejections start sees only the new session's own
graph (ROADMAP section 3): the resumed session never joins the map.

Each session's summary: frames, lost frames, nodes and WM size, loop,
proximity and inter-session links, the SLAM ATE of the whole map (every
node with a ground truth, read at its optimized pose), frame, odometry
and ``process`` ms (median and p90), the graph solves (padded size,
iterations, ms) and, for localization, the localized frames and their
errors against the ground truth, the map aligned to it as for the ATE. After each session
the store is reopened and its Node, Link and Statistics rows counted.
``scripts/jax_rgbd_sessions.py`` runs the same sessions through the JAX
package; ``chip_smoke.py`` holds the port's run on the card to it.

Usage: python -m rtabmap_tpu_torch.tools.rgbd_sessions [--device cpu]
       [--frames N] [--size W H] [--seed S] [--profile N]

``--frames N`` cuts each session to N frames (a CPU rehearsal);
``--size`` renders at another size (fx scaled alike); ``--profile N``
traces the last N frames of the resume session with ``torch.profiler``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

from rtabmap_tpu_torch.datasets.readers import Frame
from rtabmap_tpu_torch.datasets.synthetic import (
    DEFAULT_WORLD, World, loop_trajectory, render_sequence,
)
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
from rtabmap_tpu_torch.utils import metrics
from rtabmap_tpu_torch.utils.logging import device_busy_us
from rtabmap_tpu_torch.utils.params import Parameters

SESSIONS = ("mapping", "resume", "localization")
# Padded graphs past the dense solver's 400 nodes run optimize_pcg.
PCG_NODES = 400


def session_poses(name: str) -> np.ndarray:
    """Ground-truth camera poses of one session. The resume laps start
    near the mapping session's first viewpoint, at other radii and
    heights (0.118 m and 0.074 rad a step, above the RGBD/LinearUpdate
    gate); the localization frames are a stretch of a lap at radius
    1.5 m, 0.02 m up, between the mapped laps."""
    if name == "mapping":
        return sequence_spec("full")["poses"]
    if name == "resume":
        return np.concatenate([loop_trajectory(85, radius=1.6, height=-0.05),
                               loop_trajectory(85, radius=1.55, height=0.08)])
    if name == "localization":
        return loop_trajectory(80, radius=1.5, height=0.02)[20:40]
    raise KeyError(f"unknown session {name!r}; use one of {SESSIONS}")


def session_params(name: str) -> Dict:
    return {"Mem/IncrementalMemory": False} if name == "localization" else {}


def camera(size: Tuple[int, int] = (640, 480)) -> Tuple[float, float, float, float, int, int]:
    """(fx, fy, cx, cy, W, H) of the full-width camera, scaled to ``size``."""
    spec = sequence_spec("full")
    s = size[0] / spec["size"][0]
    f = spec["f"] * s
    return (f, f, (size[0] - 1) / 2.0, (size[1] - 1) / 2.0, size[0], size[1])


def inter_session_links(slam) -> int:
    """Links whose two nodes belong to different sessions, counted once."""
    sigs = slam.memory.signatures
    return sum(1 for i, s in sigs.items() for j in s.links
               if i < j and j in sigs and sigs[j].map_id != s.map_id)


def map_ate(slam) -> Tuple[float, int]:
    """(SE(3)-aligned translation RMSE, nodes) of every node that has a
    ground truth and an optimized pose."""
    opt = slam.get_optimized_poses()
    ids = [i for i in sorted(opt) if i >= 0 and (s := slam.memory.get(i)) is not None
           and s.gt_pose is not None]
    if len(ids) < 3:
        return float("nan"), len(ids)
    est = np.stack([opt[i] for i in ids])
    gt = np.stack([slam.memory.get(i).gt_pose for i in ids])
    return metrics.ate_rmse(est, gt), len(ids)


def localization_errors(slam, hist, poses) -> List[float]:
    """Translation error (m) of each localized frame's pose against its
    ground truth in the map's frame: the stored map's optimized positions
    are aligned to their ground truth (SE(3), as the ATE aligns them) and
    the localized positions are carried by the same alignment. (The map's
    first node is no anchor: its own orientation error, under 2 degrees,
    would read as centimetres a few metres away.)"""
    mem, opt = slam.memory, slam.optimized_poses
    ids = [i for i, s in mem.signatures.items()
           if s.map_id < mem.map_id and s.gt_pose is not None and i in opt]
    _, R, t = metrics.align_umeyama(np.stack([np.asarray(opt[i])[:3, 3] for i in ids]),
                                    np.stack([mem.get(i).gt_pose[:3, 3] for i in ids]))
    return [float(np.linalg.norm(R @ np.asarray(opt[st.ref_id])[:3, 3] + t - gt[:3, 3]))
            for st, gt in zip(hist, poses)
            if st.get("Loop/Localized/") > 0 and st.ref_id in opt]


def _ms(x) -> Dict[str, float]:
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return {"median": float("nan"), "p90": float("nan")}
    return {"median": float(np.median(x)), "p90": float(np.percentile(x, 90))}


def session_summary(name: str, run: Dict, poses: np.ndarray, n_stored: int) -> Dict:
    """The session's numbers (see the module docstring); ``n_stored`` is
    the node count the session loaded."""
    slam = run["slam"]
    hist = slam.stats_history[-run["frames"]:] if run["frames"] else []
    mem = slam.memory
    ate, ate_nodes = map_ate(slam)
    frame_ms = (np.add(run["odom_ms"], run["process_ms"]) + np.asarray(run["extract_ms"]))
    pcg = [(n, it, ms) for n, it, ms in slam.solves if n > PCG_NODES]
    lm = [ms for n, _, ms in slam.solves if n <= PCG_NODES]
    out = {"session": name, "frames": run["frames"], "lost": run["lost"],
           "loops": run["loops"],
           "proximity": int(sum(s.get("Proximity/Space links added/") for s in hist)),
           "inter_session_links": inter_session_links(slam),
           "nodes": len(mem.signatures), "stored_nodes": n_stored, "wm": len(mem.wm),
           "links": sum(len(s.links) for s in mem.signatures.values()),
           "map_ate": ate, "map_ate_nodes": ate_nodes, "ate_odom": run.get("ate_odom"),
           "n_words": mem.vocab.n_words,
           "quantize_calls": sum("TimingMem/Add new words/ms" in s.data for s in hist),
           "frame_ms": _ms(frame_ms), "odom_ms": _ms(run["odom_ms"]),
           "process_ms": _ms(run["process_ms"]), "extract_ms": _ms(run["extract_ms"]),
           "pcg_solves": [{"nodes": n, "iterations": it, "ms": ms} for n, it, ms in pcg],
           "dense_solves": {"count": len(lm), "ms_total": float(np.sum(lm)),
                            **_ms(lm)}}
    if not mem.incremental:
        errs = localization_errors(slam, hist, poses)
        stored = [s for s in mem.signatures.values() if s.map_id < mem.map_id]
        out.update(localized=len(errs),
                   loc_err_m={"min": float(min(errs)) if errs else float("nan"),
                              "median": float(np.median(errs)) if errs else float("nan")},
                   wm_only_stored=all(mem.get(i).map_id < mem.map_id for i in mem.wm),
                   wm_equals_stored_resident=len(mem.wm) == sum(1 for s in stored
                                                                if not s.in_ltm),
                   stm_size=mem.stm_size)
    return out


def store_counts(path: str, map_id_below: int) -> Dict[str, int]:
    """Row counts of a closed store: Node, Link and Statistics rows, and the
    Node rows of the sessions before ``map_id_below``."""
    from rtabmap_tpu_torch.memory.db import Database

    db = Database(path, async_writes=False)
    try:
        infos = db.node_infos()
        return {"node_rows": len(infos), "link_rows": len(db.all_links()),
                "statistics_rows": len(db.load_statistics()),
                "node_rows_before_session": sum(1 for r in infos
                                                if r["map_id"] < map_id_below)}
    finally:
        db.close()


def iter_sessions(path: str, device: DeviceLike = None, frames: int = 0,
                  size: Tuple[int, int] = (640, 480), seed: int = 0,
                  on_frame=None, sessions: Tuple[str, ...] = SESSIONS,
                  on_run=None) -> Iterator[Dict]:
    """Run ``sessions`` (by default all three, in order) against the store
    at ``path`` on ``device`` (None = the CUDA card), one per step of the
    iteration, each ending with its store closed; yields each session's
    summary (the raw run under ``"run"``). ``on_frame(session, i)`` is
    called right before frame i of a session is handed over;
    ``on_run(session, run)`` right after its last frame, before the
    mapping session's ``repair_graph()`` and the store's close; what it
    returns is kept under ``"on_run"``."""
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset

    dev = resolve_device(device)
    spec = sequence_spec("full")
    cam = C.CameraModel.make(*camera(size))
    world = World(spec["world"], DEFAULT_WORLD.seed)
    for name in sessions:
        poses = session_poses(name)
        if frames:
            poses = poses[:frames]
        grays, depths = render_sequence(poses, cam, world, device=dev)

        def stream(name=name, poses=poses, grays=grays, depths=depths):
            for i, (pose, gray, depth) in enumerate(zip(poses, grays, depths)):
                if on_frame is not None:
                    on_frame(name, i)
                yield Frame(stamp=float(i), gray=gray, depth=depth, gt_pose=pose)

        p = Parameters(session_params(name))
        db = Database(path)
        try:
            slam = None
            if name != "mapping":
                slam = Rtabmap.load(db, cam, p, node_capacity=spec["node_capacity"],
                                    words_per_frame=spec["max_kp"], seed=42 + seed,
                                    device=dev)
            n_stored = len(slam.memory.signatures) if slam is not None else 0
            run = run_dataset(stream(), cam, p, max_kp=spec["max_kp"],
                              node_capacity=spec["node_capacity"], db=db, slam=slam,
                              verbose=False, device=dev, seed=seed)
            seen = on_run(name, run) if on_run is not None else None
            repaired = run["slam"].repair_graph() if name == "mapping" else []
            res = session_summary(name, run, poses, n_stored)
            res["repaired_links"] = [list(lk) for lk in repaired]
            run["slam"].close()
        finally:
            db.close()
        res["store"] = store_counts(path, run["slam"].memory.map_id)
        res["run"] = run
        if on_run is not None:
            res["on_run"] = seen
        yield res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=0, help="cut each session (0 = whole)")
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480), metavar=("W", "H"))
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC generators")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the last N frames of the resume session")
    args = ap.parse_args(argv)
    prof, window = None, {}
    n_resume = args.frames or len(session_poses("resume"))
    n = min(args.profile, n_resume)
    if n:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(session, i):
        if prof is not None and session == "resume" and i == n_resume - n:
            prof.__enter__()
            window["t0"] = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        for res in iter_sessions(path, args.device, args.frames, tuple(args.size), args.seed,
                                 on_frame=start):
            res.pop("run")
            if prof is not None and res["session"] == "resume":
                # the session's last frame ended in a synchronize
                wall_us = (time.perf_counter() - window["t0"]) * 1e6
                prof.__exit__(None, None, None)
                print(prof.key_averages().table(sort_by="self_device_time_total",
                                                row_limit=20))
                busy_us, n_ops = device_busy_us(prof)
                top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
                res["profile_last_frames"] = {
                    "frames": n, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                    "device_busy_share": busy_us / wall_us,
                    "device_ops_per_frame": n_ops / n,
                    "top_device_ops_ms": {e.key: e.self_device_time_total / 1e3 for e in top}}
                prof = None
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

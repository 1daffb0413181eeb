"""Navigation on a saved map: labels, a goal, the planned path followed.

The user path of a robot that navigates a map it made earlier (rtabmap_ros
on a stored map): an operator labels places with the store tool
(``db_edit <store> set_label``), the robot loads the store and localizes
in it, it is sent a goal, and every ``Rtabmap.process`` tick plans a
topological path, keeps the path connected with virtual links, pages the
path's upcoming nodes back from the store (long-term memory) and reports
the current sub-goal, until the goal is reached.

The map is ``rgbd_sessions``' mapping session (``rgbd_laps``' ``full``
sequence: two 60-frame laps at 640x480 into a store). ``dock`` labels the
node of lap 1's first frame, ``desk`` the node of its frame 30. The drive
renders lap 1's poses from frame 30 back to frame 0 (31 frames, the
mapped views driven backwards) through ``run_dataset`` (F2M odometry
started at the identity, seeded as ``rgbd_sessions``' localization
seeds it). The engine is loaded in localization mode:
``Mem/IncrementalMemory`` false (the map stays frozen) and
``Rtabmap/MemoryThr`` ``MEMORY_THR``, so the first tick moves the oldest
half of the map, lap 1 with ``dock``, to long-term memory.

``GoalTracker`` feeds the frames and, between ticks, sends the goal
(``set_goal(dock)``) as soon as the current node is linked to the map
(``compute_path`` finds a path), then records each tick's
``Planning/*`` statistics and retrievals and stops the stream once the
goal is reached (``path_status`` 1). ``scripts/jax_navigation.py`` runs
the same drive through the JAX package; ``chip_smoke.py``'s
``navigation`` phase holds the port's run on the card to it.

Usage: python -m rtabmap_tpu_torch.tools.navigation [--device cpu]
       [--frames N] [--size W H] [--seed S]

maps a store (``--frames`` cuts the mapping session, ``--size`` renders
at another size) in a temporary directory, labels it and drives; prints
the drive's summary as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.memory.memory import LINK_VIRTUAL_CLOSURE

LAP = 60            # frames of the mapping session's first lap
DOCK_FRAME = 0      # lap-1 frame whose node is labelled "dock"
DESK_FRAME = 30     # lap-1 frame whose node is labelled "desk"
START_FRAME = 30    # the drive starts here and runs back to frame 0
MEMORY_THR = 60     # WM nodes kept: the first tick spills lap 1 to LTM


def drive_poses(start: int = START_FRAME) -> np.ndarray:
    """Lap 1's ground-truth poses from frame ``start`` back to frame 0."""
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    return sequence_spec("full")["poses"][:LAP][start::-1]


def drive_params() -> Dict:
    """The drive's engine parameters: localization mode, lap 1 in LTM."""
    return {"Rtabmap/MemoryThr": MEMORY_THR, "Mem/IncrementalMemory": False}


def node_for_frame(infos: List[Dict], frame: int) -> int:
    """The first session's node whose ground truth lies nearest lap 1's
    pose at ``frame`` (the lowest id on a tie); ``infos`` are a store's
    ``node_infos()`` rows."""
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec

    target = sequence_spec("full")["poses"][frame][:3, 3]
    first = min(r["map_id"] for r in infos)
    best = min((float(np.linalg.norm(np.asarray(r["gt"])[:3, 3] - target)), r["id"])
               for r in infos if r["map_id"] == first and r["gt"] is not None)
    return best[1]


def labelled(slam, label: str) -> int:
    """The id of the node labelled ``label`` (0 when none is)."""
    return next((i for i, s in sorted(slam.memory.signatures.items())
                 if s.label == label), 0)


def virtual_links(slam) -> int:
    """Virtual-closure links in the engine's memory, counted once."""
    return sum(1 for i, s in slam.memory.signatures.items()
               for j, lk in s.links.items() if i < j and lk.type == LINK_VIRTUAL_CLOSURE)


class GoalTracker:
    """Feeds a frame stream to a run of either package's engine and drives
    the planner between ticks: ``set_goal(goal_id)`` after the first tick
    at which ``compute_path`` reaches the goal, then one record a tick, and
    no frame after the tick that reached it. After the run: ``path`` (the
    planned path), ``planned_at`` and ``reached_at`` (frames processed
    when the goal was set and when it was reached, None when not),
    ``ticks`` (the Planning/* statistics, retrievals, the accepted
    hypothesis and the path nodes paged back from LTM, with those outside
    the highest hypothesis' retrieval neighbourhood, of every tick after
    planning), ``frames`` and
    ``start`` (the newest node when planned) and ``ltm_on_path`` (the
    path's nodes in long-term memory when planned)."""

    def __init__(self, slam, goal_id: int):
        self.slam, self.goal_id = slam, goal_id
        self.path: List[int] = []
        self.planned_at: Optional[int] = None
        self.reached_at: Optional[int] = None
        self.ticks: List[Dict] = []
        self.frames = 0
        self.start = 0
        self.ltm_on_path = 0

    def stream(self, frames: Iterable):
        for fr in frames:
            if self.reached_at is not None:
                return
            in_ltm = self._path_in_ltm()
            yield fr
            self.frames += 1
            self._after_tick(in_ltm)

    def _path_in_ltm(self) -> List[int]:
        mem = self.slam.memory
        return [i for i in self.slam.get_path() if (s := mem.get(i)) is not None and s.in_ltm]

    def _after_tick(self, in_ltm: List[int]):
        slam = self.slam
        st = slam.stats_history[-1]
        if self.planned_at is not None:
            # the path nodes this tick paged back from LTM, and those of them
            # outside the highest hypothesis' retrieval neighbourhood
            paged = [i for i in in_ltm if not slam.memory.get(i).in_ltm]
            hyp = int(st.get("Loop/Highest hypothesis id/"))
            near = set(slam._graph_neighborhood(hyp, slam.retrieval_margin)) if hyp else set()
            self.ticks.append({
                "paged_path": paged, "paged_by_path_only": [i for i in paged if i not in near],
                "frame": self.frames, "ref_id": st.ref_id,
                "goal_id": int(st.get("Planning/Current goal id/")),
                "path_length": int(st.get("Planning/Path length/")),
                "status": int(st.get("Planning/Status/")),
                "reactivate_id": int(st.get("Loop/Reactivate id/")),
                "retrieved": int(st.get("Memory/Retrieved/")),
                "accepted_id": int(st.get("Loop/Accepted hypothesis id/")),
                "planning_ms": st.get("Timing/Path planning/ms")})
            if slam.path_status == 1:
                self.reached_at = self.frames
        elif slam.compute_path(self.goal_id) and slam.set_goal(self.goal_id):
            self.planned_at = self.frames
            self.start = slam.get_last_location_id()
            self.path = list(slam.get_path())
            self.ltm_on_path = sum(1 for i in self.path
                                   if (s := slam.memory.get(i)) is not None and s.in_ltm)

    def summary(self) -> Dict:
        """The drive's numbers (see ``check``)."""
        path_pos = {i: k for k, i in enumerate(self.path)}
        goal_pos = [path_pos.get(t["goal_id"], -1) for t in self.ticks if t["goal_id"]]
        paged = [t for t in self.ticks if t["reactivate_id"] > 0]
        return {"frames": self.frames, "planned_at": self.planned_at,
                "reached_at": self.reached_at, "goal_id": self.goal_id, "start": self.start,
                "path": self.path, "path_length": len(self.path),
                "ltm_on_path": self.ltm_on_path,
                "status": int(self.slam.path_status),
                "goal_index_monotone": all(b >= a for a, b in zip(goal_pos, goal_pos[1:])),
                "goal_ids_on_path": all(p >= 0 for p in goal_pos),
                "reactivation_ticks": len(paged),
                "retrieved": int(sum(t["retrieved"] for t in self.ticks)),
                "path_nodes_paged": int(sum(len(t["paged_path"]) for t in self.ticks)),
                "ticks_paging_by_path_only": sum(1 for t in self.ticks
                                                 if t["paged_by_path_only"]),
                "virtual_links_left": virtual_links(self.slam),
                "ticks": self.ticks}


def label_store(path: str, device: DeviceLike = None) -> Tuple[int, int]:
    """Label ``dock`` and ``desk`` through the store tool ``db_edit``;
    returns their ids."""
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.tools import cli

    db = Database(path, async_writes=False)
    infos = db.node_infos()
    db.close()
    dock, desk = node_for_frame(infos, DOCK_FRAME), node_for_frame(infos, DESK_FRAME)
    dev = ["--device", str(resolve_device(device))]
    cli.main(["db_edit", path, "set_label", str(dock), "dock", *dev])
    cli.main(["db_edit", path, "set_label", str(desk), "desk", *dev])
    return dock, desk


def navigate(path: str, device: DeviceLike = None, seed: int = 0,
             size: Tuple[int, int] = (640, 480), start: int = START_FRAME):
    """Load the labelled store at ``path`` in localization mode on
    ``device`` (None = the CUDA card) and drive from lap 1's frame ``start`` back to ``dock``.
    Returns (the tracker, ``run_dataset``'s output); the store is left open
    in the engine (``slam.memory.db``)."""
    from rtabmap_tpu_torch.datasets.readers import Frame
    from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD, World, render_sequence
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset
    from rtabmap_tpu_torch.tools.rgbd_laps import sequence_spec
    from rtabmap_tpu_torch.tools.rgbd_sessions import camera
    from rtabmap_tpu_torch.utils.params import Parameters

    dev = resolve_device(device)
    spec = sequence_spec("full")
    cam = C.CameraModel.make(*camera(size))
    poses = drive_poses(start)
    grays, depths = render_sequence(poses, cam, World(spec["world"], DEFAULT_WORLD.seed),
                                    device=dev)
    p = Parameters(drive_params())
    slam = Rtabmap.load(Database(path), cam, p, node_capacity=spec["node_capacity"],
                        words_per_frame=spec["max_kp"], seed=42 + seed,
                        new_session=True, device=dev)
    tracker = GoalTracker(slam, labelled(slam, "dock"))
    frames = (Frame(stamp=float(i), gray=g, depth=d, gt_pose=pose)
              for i, (pose, g, d) in enumerate(zip(poses, grays, depths)))
    run = run_dataset(tracker.stream(frames), cam, p, max_kp=spec["max_kp"],
                      node_capacity=spec["node_capacity"], slam=slam, verbose=False,
                      device=dev, seed=seed)
    return tracker, run


def main(argv=None):
    from rtabmap_tpu_torch.tools import rgbd_sessions

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=0, help="cut the mapping session (0 = whole)")
    ap.add_argument("--size", type=int, nargs=2, default=(640, 480), metavar=("W", "H"))
    ap.add_argument("--seed", type=int, default=0, help="shifts the RANSAC generators")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.db")
        next(rgbd_sessions.iter_sessions(path, args.device, args.frames, tuple(args.size),
                                         args.seed, sessions=("mapping",)))
        dock, desk = label_store(path, args.device)
        tracker, run = navigate(path, args.device, args.seed, tuple(args.size))
        run["slam"].memory.db.close()
        out = {"dock": dock, "desk": desk, **tracker.summary()}
        out.pop("ticks")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

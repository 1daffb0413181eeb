"""The PnP-RANSAC as one captured CUDA graph against its eager ops, on the
card: where the odometry's time went, what the graph saves, and that both
give the same numbers.

1. cProfile of the RGB-D ``full`` sequence's first ``--frames`` frames
   through ``run_dataset`` (F2M odometry) with the eager PnP-RANSAC: the
   share of the run inside ``ransac_pnp``, and the launches a frame
   (``torch.profiler``'s ``cudaLaunchKernel`` count over 8 frames).
2. The same frames with the graph and eagerly, twice each in turn: the
   odometry, frame and ``process`` ms (medians, p90) and the ATEs.
3. Every unbatched ``ransac_pnp`` call of a graphed run replayed both ways
   on the same inputs and draws: the count of calls whose outputs differ.
4. F2F and mono (``tools/odometries.py``) both ways.

Usage (on the card, from the repository root):
    python3 scripts/pnp_graph_study.py [--frames 40]
"""
from __future__ import annotations

import argparse
import cProfile
import functools
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtabmap_tpu_torch.ops import ransac as R  # noqa: E402
from rtabmap_tpu_torch.tools import odometries as OD  # noqa: E402
from rtabmap_tpu_torch.tools import rgbd_laps  # noqa: E402

ORIG = R.ransac_pnp
KEYS = ("loops", "lost", "ate_odom", "ate_slam", "odom_ms", "frame_ms", "process_ms")


def use_graphs(on: bool, record=None):
    """Route every caller's ``R.ransac_pnp`` through the graph or eagerly;
    ``record`` collects the calls' arguments."""
    def recording(*a, **k):
        record.append((a, dict(k)))
        return ORIG(*a, **k)

    R.ransac_pnp = (recording if record is not None else ORIG) if on else \
        functools.partial(ORIG, graphs=False)


def run(dev, frames, tag, graphs, record=None):
    use_graphs(graphs, record)
    t = time.perf_counter()
    out = rgbd_laps.run_sequence("full", dev, frames)
    torch.cuda.synchronize()
    print(json.dumps({"tag": tag, "graphs": graphs, "wall_s": time.perf_counter() - t,
                      **{k: out[k] for k in KEYS}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    dev = torch.device("cuda")
    run(dev, 6, "warm-up", False)
    prof = cProfile.Profile()
    use_graphs(False)
    t = time.perf_counter()
    prof.enable()
    rgbd_laps.run_sequence("full", dev, args.frames)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    pnp_s = next(v[3] for k, v in stats.items()
                 if k[2] == "ransac_pnp" and k[0].endswith(os.path.join("ops", "ransac.py")))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        rgbd_laps.run_sequence("full", dev, 8)
        torch.cuda.synchronize()
    launches = sum(e.count for e in p.key_averages() if e.key == "cudaLaunchKernel")
    print(json.dumps({"eager_profile": {"frames": args.frames, "wall_s": wall,
                                        "ransac_pnp_s": pnp_s, "ransac_pnp_share": pnp_s / wall,
                                        "launches_per_frame": launches / 8}}), flush=True)
    calls = []
    for i in range(2):
        run(dev, args.frames, f"eager{i}", False)
        run(dev, args.frames, f"graph{i}", True, calls if i == 0 else None)
    use_graphs(True)
    differing = 0
    compared = [(a, k) for a, k in calls if a[0].dim() == 2]
    for i, (a, k) in enumerate(compared):
        k.pop("generator", None)
        if k.get("indices") is None:
            k["indices"] = R.pnp_sample_indices(torch.Generator().manual_seed(i), a[2],
                                                k.get("iters", 256),
                                                k.get("pts3d_query") is not None)
        g, e = ORIG(*a, **k), ORIG(*a, **k, graphs=False)
        differing += not all(torch.equal(x, y) for x, y in zip(g, e))
    print(json.dumps({"graph_vs_eager": {"calls": len(compared), "differing": differing,
                                         "graphs": len(R._PNP_GRAPHS)}}), flush=True)
    for name in ("f2f", "mono"):
        for graphs in (False, True):
            use_graphs(graphs)
            t = time.perf_counter()
            out = OD.run_odometry(name, dev)
            out.pop("est", None)
            print(json.dumps({"run": name, "graphs": graphs,
                              "wall_s": time.perf_counter() - t, **out}), flush=True)
    use_graphs(True)


if __name__ == "__main__":
    main()

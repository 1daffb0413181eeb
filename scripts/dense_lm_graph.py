"""The dense pose-graph LM as one captured CUDA graph against its eager loop.

Builds noisy planar rings of N nodes (odometry edges, a closure every
eighth node and one wrong closure), padded to powers of two as the engine
pads its graphs, and runs ``optimize_dense`` for 12 LM iterations (the
engine's chunk) with ``graphs=True`` and ``graphs=False``: plain, with
priors on every third node (the engine's incremental subgraphs), and
robust with DCS switchable closures. Prints one JSON line per case: the
poses' largest difference (m), both chi2, the first call's time (the
capture included) and the median time of later calls (host clock to a
sync), with the card's name and power limit.

Usage (from the repository root, on a CUDA machine):
    python scripts/dense_lm_graph.py [--sizes 32 128 256] [--reps 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtabmap_tpu_torch.geometry import transform as T  # noqa: E402
from rtabmap_tpu_torch.optim import pose_graph as PG  # noqa: E402


def ring(n: int, priors: bool, device: str, seed: int = 0):
    """(graph padded to powers of two on the card, switch mask)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0], xi[:, 1], xi[:, 5] = 3 * np.cos(ang), 3 * np.sin(ang), ang + np.pi / 2
    gt = T.se3_exp(torch.from_numpy(xi))
    closures = list(range(0, n - 8, 8))
    ef = list(range(n - 1)) + closures + [0]            # the last closure is wrong
    et = list(range(1, n)) + [k + 8 for k in closures] + [n // 2]
    noise = torch.from_numpy(rng.normal(0, [0.02, 0.02, 0.005, 0.002, 0.002, 0.01],
                                        (len(ef), 6)).astype(np.float32))
    ef_t, et_t = torch.tensor(ef), torch.tensor(et)
    meas = T.retract(T.relative(gt[ef_t], gt[et_t]), noise)
    meas[-1] = T.retract(meas[-1], torch.tensor([1.0, -0.5, 0, 0, 0, 0.4]))  # a wrong closure
    init = [gt[0]]
    for k in range(n - 1):
        init.append(T.compose(init[-1], meas[k]))
    init = torch.stack(init)
    E = len(ef)
    Np, Ep = 1 << (n - 1).bit_length(), 1 << (E - 1).bit_length()
    P = torch.eye(3, 4).repeat(Np, 1, 1)
    P[:n] = init
    pad = lambda a, m, fill: np.concatenate([a, np.full((m - len(a),) + a.shape[1:], fill)])  # noqa: E731
    info = np.tile(np.eye(6, dtype=np.float32) * 100, (Ep, 1, 1))
    meas_p = np.tile(np.eye(3, 4, dtype=np.float32), (Ep, 1, 1))
    meas_p[:E] = meas.numpy()
    kw = {}
    if priors:
        idx = np.arange(0, n, 3)
        pm = init[idx].numpy().copy()
        pm[:, 0, 3] += 0.05
        pi = np.zeros((len(idx), 6, 6), np.float32)
        pi[:, :3, :3] = np.eye(3) * 100.0
        Pp = 1 << (len(idx) - 1).bit_length()
        kw = dict(priors_idx=pad(idx, Pp, 0), priors_meas=pad(pm, Pp, 0.0),
                  priors_info=pad(pi, Pp, 0.0), prior_valid=np.arange(Pp) < len(idx))
        kw["priors_meas"][len(idx):] = np.eye(3, 4)
    g = PG.make_graph(P.numpy(), pad(np.array(ef), Ep, 0), pad(np.array(et), Ep, 0), meas_p,
                      info, node_valid=np.arange(Np) < n, edge_valid=np.arange(Ep) < E,
                      root=0, device=device, **kw)
    switch = torch.zeros(Ep, dtype=torch.bool, device=device)
    switch[n - 1:E] = True
    return g, switch


def timed(fn):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[32, 128, 256])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cpu runs the eager loop twice")
    args = ap.parse_args(argv)
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    for n in args.sizes:
        for case in ("plain", "priors", "dcs"):
            g, switch = ring(n, priors=case == "priors", device=args.device)
            sm = switch if case == "dcs" else None
            (eg, ec), eager_ms = timed(lambda: PG.optimize_dense(
                g, iters=12, robust=case == "dcs", switch_mask=sm, graphs=False))
            (cg, cc), first_ms = timed(lambda: PG.optimize_dense(
                g, iters=12, robust=case == "dcs", switch_mask=sm))
            ms = []
            for _ in range(args.reps):
                (cg, cc), t = timed(lambda: PG.optimize_dense(
                    g, iters=12, robust=case == "dcs", switch_mask=sm))
                ms.append(t)
            print(json.dumps({"nodes": n, "padded": int(g.poses.shape[0]), "case": case,
                              "max_abs_diff_m": float((cg.poses - eg.poses).abs().max()),
                              "chi2_graph": float(cc), "chi2_eager": float(ec),
                              "eager_ms": eager_ms, "first_graph_ms": first_ms,
                              "graph_ms_median": float(np.median(ms)), "card": card}),
                  flush=True)


if __name__ == "__main__":
    main()

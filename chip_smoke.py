"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases — any failure ends the run with a non-zero exit code:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the path from ``rtabmap_tpu_torch/csrc``
   (one nvcc per source, all at once) into ``build/``;
3. kernels: holds each kernel against its plain PyTorch version on the card
   with exact equality, and times kernel, plain version, one PyTorch
   library call of the same function, and the bound: the vocabulary 2-NN
   (K1) at Q=400 against the 262144-row slab with 70% valid words, against
   a slab whose valid words are the prefix of 31853 rows (the BOW cell's
   end state) both whole and as the prefix the dictionary passes, and at a
   ragged Q=37 x W=5000; the 3-D 1-NN (K2) at the LiDAR path's shapes, a
   28800-point VLP-16 scan against a 2048- and a 16384-point odometry map
   and against another scan, each unmasked and with the scans' 5 cm voxel
   masks (queries and points), and at the edge cases: a ragged 37 x 5000
   with 30% invalid and duplicated points, with and without a 30% query
   mask, no valid point, no valid query, one valid query and point, 1 x 1;
   K2's compaction kernel against its plain version; one masked search
   under ``torch.cuda.set_sync_debug_mode("error")`` (it must not sync).
   Kernel times are one eager call each (``kernel_ms``, as the earlier
   slices timed them, the kernels line's ``ms``) and the device time of a
   CUDA graph of ten calls (``graph_ms``);
4. slice ``bow_mapping``: the appearance-only tick —
   ``FeatureExtractor.extract`` -> ``Rtabmap.process`` with
   RGBD/Enabled=false on cuda, 640x480 renders of two 150-frame laps, 400
   keypoints, the default 262144-word vocabulary, 1024 node slots; lap 2
   must close with lap-1 nodes of the same viewpoint at least as often as
   the threshold below;
5. slice ``lidar_mapping``: ``run_lidar_mapping`` (scan-to-map ICP
   odometry, proximity closures, dense pose graph, voxel map) on cuda over
   ``lidar_trajectory(150, radius=2.0)`` with sensor-frame noise of
   sigma 0.01 m: first at the parity width 16 x 225, held against the JAX
   package's CPU run of the same sequence (``scripts/jax_lidar_mapping.py``),
   then at the full VLP-16 width 16 x 1800 = 28800 points a scan with a
   16384-point local map, held against the simulator's ground truth, timed.

Each slice zeroes the launch counts of its kernels right before it and
reads them right after; they must equal the calls the slice made (K2:
one search launch a search, one compaction launch a prepared destination).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from rtabmap_tpu_torch.datasets.synthetic import VLP16_AZIMUTH
from rtabmap_tpu_torch.ops.cloud import voxel_filter
from rtabmap_tpu_torch.ops.cuda import build
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from rtabmap_tpu_torch.ops.cuda import vocab_knn as K1
from rtabmap_tpu_torch.tools import bow_laps
from rtabmap_tpu_torch.tools import lidar_mapping as LM

# H100 SXM dense peaks (NVIDIA data sheet): HBM bytes/s, int8 tensor op/s,
# and FP32-pipe instructions/s outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two operations, so 33.5e12 instructions.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_INSTR_PER_S = 67e12 / 2

FRAMES_PER_LAP = bow_laps.FRAMES_PER_LAP
# Lap-2 ticks that close with a lap-1 node of the same viewpoint (+-3
# frames): the JAX package's own CPU run of this sequence
# (scripts/jax_bow_laps.py) counts JAX_LAP2_SAME_VIEW. The port on the card
# must reach 90% of it: float sums run in another order on the card (blur
# products, likelihood reductions, atomics in the Bayes scatter), which can
# move a near-tie keypoint or hypothesis.
JAX_LAP2_SAME_VIEW = 97
LAP2_THRESHOLD = int(0.9 * JAX_LAP2_SAME_VIEW)

# The LiDAR sequence: 150 frames, one closed 12.6 m loop at 0.084 m a frame
# (walking speed at 10 Hz), sensor-frame noise sigma 0.01 m.
LIDAR_FRAMES = 150
LIDAR_NOISE = 0.01
PARITY_AZIMUTH = 225          # parity width: 16 x 225 = 3600 points
# The JAX package's CPU run of the parity-width sequence
# (scripts/jax_lidar_mapping.py: 381.2 s on an 8-core CPU host): 150 nodes,
# 139 proximity closures, 0 lost frames, ATE 0.02543 m after the graph
# solve. The card must reach 90% of the closures, lose no more frames and
# stay within 0.01 m of that ATE: sums run in another order on the card
# (and the normals of near-collinear ring neighbourhoods are ill-
# conditioned), which moves a borderline registration.
JAX_LIDAR_CLOSURES = 139
JAX_LIDAR_LOST = 0
JAX_LIDAR_ATE = 0.025430718484748708
# Full width: the bound the JAX package's own scan-odometry test holds its
# odometry to (tests/test_scan_odometry.py), here for the solved graph.
FULL_WIDTH_ATE = 0.05


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def _event_ms(run, reps: int) -> list:
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one eager call of ``fn``
    after warm-up: the card waits for the host's launch, so a small
    kernel's time includes its wrapper's. Every ``ms``, ``plain_ms`` and
    ``library_ms`` is timed so, as in the earlier slices."""
    for _ in range(warmup):
        fn()
    return float(np.median(_event_ms(fn, reps)))


def graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured in one
    CUDA graph and replayed, median of ``reps`` CUDA-event timings over
    ``inner``; the host's launch time is left out."""
    fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    return float(np.median(_event_ms(g.replay, reps))) / inner


# ------------------------------------------------------------------ kernels


def knn2_case(Q: int, W: int, seed: int, n_prefix: int = 0):
    """Seeded +-1 slab with duplicated rows (ties) and 30% invalid words,
    or, with ``n_prefix``, valid words exactly the first ``n_prefix`` rows;
    queries drawn half from the slab's valid rows, one zero (invalid
    keypoint) row."""
    rng = np.random.default_rng(seed)
    slab = (rng.integers(0, 2, (W, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    dup = rng.integers(0, W, W // 10)
    slab[rng.integers(0, W, W // 10)] = slab[dup]
    valid = rng.random(W) >= 0.3
    if n_prefix:
        valid = np.arange(W) < n_prefix
    q = (rng.integers(0, 2, (Q, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    q[: Q // 2] = slab[rng.integers(0, n_prefix or W, Q // 2)]
    q[-1] = 0
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev), torch.from_numpy(slab).to(dev),
            torch.from_numpy(valid).to(dev))


def knn2_library(q, slab, valid):
    """One PyTorch library product + top-k computing the same 2-NN (the
    yardstick; the port never calls it)."""
    sim = torch._int_mm(q, slab.T)
    d2 = torch.where(valid, 256 - sim, 1 << 20)
    return torch.topk(d2, 2, dim=1, largest=False)


def knn2_bound_ms(Q: int, W: int, n_valid: int) -> tuple:
    """Least time for the work these inputs need: the valid words' rows
    read once, the queries and flags read once, the (Q,2) outputs written
    once; 2*Q*n_valid*256 int8 operations."""
    bytes_ = Q * 256 + W + n_valid * 256 + Q * 2 * 8
    ops = 2.0 * Q * n_valid * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_knn2():
    """K1 bit for bit against its plain version; times at the path's
    shapes. Returns the kernels-line entry at the dictionary's prefix call
    of the BOW cell's end state (Q=400 x 31853 valid rows)."""
    rows = {}
    # BOW cell's end state: 31853 words in the 262144-row slab
    cases = (("full-70", 400, 262144, 0, 0), ("end-state", 400, 262144, 3, 31853),
             ("ragged", 37, 5000, 1, 0))
    for name, Q, W, seed, n_prefix in cases:
        q, slab, valid = knn2_case(Q, W, seed, n_prefix)
        calls = [(name, slab, valid)]
        if n_prefix:   # the call the dictionary makes: its valid prefix only
            calls.append(("prefix", slab[:n_prefix], valid[:n_prefix]))
        for label, sl, va in calls:
            # torch._int_mm takes a multiple of 8 rows: the rows after the
            # prefix are invalid, so the padded call computes the same 2-NN
            w8 = -(-sl.shape[0] // 8) * 8
            lib_args = (slab[:w8], valid[:w8])
            d, i = K1.knn2(q, sl, va)
            torch.cuda.synchronize()
            dr, ir = K1.knn2_reference(q, sl, va)
            if not (torch.equal(d, dr) and torch.equal(i, ir)):
                bad = int(((d != dr).any(1) | (i != ir).any(1)).sum())
                fail(f"vocab_knn2 disagrees with its plain version ({label}, Q={Q} "
                     f"W={sl.shape[0]}) on {bad} queries")
            if label == "prefix" and not (torch.equal(d, rows["end-state"]["_d"])
                                          and torch.equal(i, rows["end-state"]["_i"])):
                fail("vocab_knn2 on the valid prefix differs from the whole slab")
            bound, bound_by = knn2_bound_ms(Q, sl.shape[0], int(va.sum()))
            row = {"kernel": "vocab_knn2", "case": label, "Q": Q, "W": sl.shape[0],
                   "n_valid": int(va.sum()), "equal": True,
                   "kernel_ms": time_ms(lambda: K1.knn2(q, sl, va)),
                   "graph_ms": graph_ms(lambda: K1.knn2(q, sl, va)),
                   "plain_ms": time_ms(lambda: K1.knn2_reference(q, sl, va), reps=10),
                   "library_ms": time_ms(lambda: knn2_library(q, *lib_args)),
                   "bound_us": bound * 1e3, "bound_by": bound_by}
            print(json.dumps(row), flush=True)
            rows[label] = dict(row, _d=d, _i=i)
    main_shape = rows["prefix"]
    return {"name": "vocab_knn2", "route": "cuda",
            "source": "rtabmap_tpu_torch/csrc/vocab_knn.cu",
            "replaces": "rtabmap_tpu/ops/pallas/vocab_knn.py:80",
            "max_abs_err": 0.0, "ms": main_shape["kernel_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] * 1e-3,
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"]}


# K2 cases timed beside their bound: (name, launches a full-width frame)
NN3D_PATH = ("odometry-2048", "odometry", "closure",
             "odometry-2048-masked", "odometry-masked", "closure-masked")


def nn3d_cases():
    """(name, src, dst, dst_valid, src_valid) on the card. The LiDAR path
    shapes use two consecutive VLP-16 scans of the slice's sequence: the
    odometry search takes a scan against the local map (voxel-filtered
    points of the other scan, spread over it): 2048 points as in the
    parity-width run (OdomF2M/ScanMaxSize), 16384 as in the full-width run;
    the closure search a scan against a voxel-filtered scan. Each path
    shape runs unmasked (every query searched, as before the query mask)
    and masked with the scan's 5 cm voxel flags, as the path calls it.
    Then the edge cases."""
    dev = torch.device("cuda")
    _, scans = LM.sensor_sequence(2, noise=LIDAR_NOISE, device=dev)
    (a, a_valid), (b, b_valid) = list(scans)
    a_mask = voxel_filter(a, a_valid, 0.05)
    b_mask = voxel_filter(b, b_valid, 0.05)
    idx = torch.nonzero(a_mask)[:, 0]
    cases = []
    for name, m in (("odometry-2048", 2048), ("odometry", LM.VLP16_MAP_CAPACITY)):
        # a full map holds valid points only; repeat the scan's to fill it
        sel = idx.repeat(-(-m // idx.numel()))[:m] if m > idx.numel() else \
            idx[:: max(1, idx.numel() // m)][:m]
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        cases.append((name, b, a[sel].contiguous(), ones, None))
        cases.append((name + "-masked", b, a[sel].contiguous(), ones, b_mask))
    cases.append(("closure", b, a, a_mask, None))
    cases.append(("closure-masked", b, a, a_mask, b_mask))
    rng = np.random.default_rng(2)
    dst = rng.normal(size=(5000, 3)).astype(np.float32)
    dst[rng.integers(0, 5000, 500)] = dst[rng.integers(0, 5000, 500)]
    src = rng.normal(size=(37, 3)).astype(np.float32)
    src[:18] = dst[rng.integers(0, 5000, 18)]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ragged_valid = t(rng.random(5000) >= 0.3)
    cases.append(("ragged", t(src), t(dst), ragged_valid, None))
    cases.append(("ragged-masked", t(src), t(dst), ragged_valid, t(rng.random(37) >= 0.3)))
    pts64, pts1000 = t(rng.normal(size=(64, 3)).astype(np.float32)), \
        t(rng.normal(size=(1000, 3)).astype(np.float32))
    cases.append(("no-valid-point", pts64, pts1000, t(np.zeros(1000, bool)), None))
    cases.append(("no-valid-point-masked", pts64, pts1000, t(np.zeros(1000, bool)),
                  t(rng.random(64) >= 0.3)))
    cases.append(("no-valid-query", pts64, pts1000, t(np.ones(1000, bool)),
                  t(np.zeros(64, bool))))
    cases.append(("one-of-each", pts64, pts1000, t(np.arange(1000) == 617),
                  t(np.arange(64) == 40)))
    cases.append(("one", t(np.ones((1, 3), np.float32)), t(np.zeros((1, 3), np.float32)),
                  t(np.ones(1, bool)), None))
    return cases


def nn3d_library(src, dst, valid, src_valid):
    """One PyTorch library distance call + masks + min computing the same
    nearest neighbour (the yardstick; the port never calls it)."""
    d, i = torch.cdist(src, dst).masked_fill(~valid, float("inf")).min(dim=1)
    if src_valid is None:
        return d, i
    return d.masked_fill(~src_valid, float("inf")), i.masked_fill(~src_valid, 0)


def nn3d_bound_ms(Q: int, N: int, n_query: int, n_point: int) -> tuple:
    """Least time for the work these inputs need. Pairs: only those of a
    valid query (all Q without a query mask) and a valid point: no caller
    reads a masked query's result, and an invalid point cannot be a
    neighbour. Each pair costs 8 FP32-pipe instructions: 3 subtractions,
    3 multiplications and 2 additions, none of which the bit-exact
    contract lets fuse into an FMA, at 33.5e12 a second. The compare and
    the two selects of the running minimum are not counted: which pipe
    issues them is not documented, and on the integer/logic pipe (64
    lanes an SM, half the FP32 pipe's 128) their 3 take less time than
    the 8, so only the 8 surely bound the time. Bytes: the valid queries and
    points (12 bytes each) and both masks read once, the (d, idx)
    outputs (8 bytes a query) written once."""
    bytes_ = 12 * n_query + 12 * n_point + N + Q + 8 * Q
    ops = 8.0 * n_query * n_point
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compact_bound_ms(Q: int, N: int, n_point: int) -> tuple:
    """Least time of K2's compaction: points (12 bytes) and both masks read
    once, the compacted points (16 bytes), their indices, the query order
    and the counts written once; no arithmetic to speak of."""
    bytes_ = 12 * N + N + Q + 20 * n_point + 4 * Q + 8
    return bytes_ / HBM_BYTES_PER_S * 1e3, "bytes"


def check_compact(name, dst, valid, src_valid):
    """K2's compaction kernel against its plain version: the valid points
    and their indices in order, the query order, the counts."""
    plan = K2.nn3d_prepare(dst, valid, src_valid)
    torch.cuda.synchronize()
    d4, dl, ql, counts = K2.nn3d_compact_reference(dst, valid, src_valid)
    n_pt = d4.shape[0]
    got = plan.counts.cpu()
    ok = (int(got[0]) == int(counts[0]) and torch.equal(plan.dst4[:n_pt], d4)
          and torch.equal(plan.dlist[:n_pt], dl) and (ql is None) == (plan.qlist is None))
    if ql is not None:
        ok = ok and int(got[1]) == int(counts[1]) and torch.equal(plan.qlist, ql)
    if not ok:
        fail(f"nn3d_compact disagrees with its plain version ({name})")


def check_nn3d():
    rows, cases = {}, nn3d_cases()
    for name, src, dst, valid, src_valid in cases:
        check_compact(name, dst, valid, src_valid)
        d, i = K2.nn3d(src, dst, valid, src_valid)
        torch.cuda.synchronize()
        dr, ir = K2.nn3d_reference(src, dst, valid, src_valid)
        if not (torch.equal(d, dr) and torch.equal(i, ir)):
            bad = int(((d != dr) | (i != ir)).sum())
            fail(f"nn3d disagrees with its plain version on {bad} of {src.shape[0]} "
                 f"queries ({name}, Q={src.shape[0]} N={dst.shape[0]})")
        Q, N = src.shape[0], dst.shape[0]
        n_query = Q if src_valid is None else int(src_valid.sum())
        n_point = int(valid.sum())
        row = {"kernel": "nn3d", "case": name, "Q": Q, "N": N, "valid_queries": n_query,
               "valid_points": n_point, "equal": True}
        if name in NN3D_PATH:
            plan = K2.nn3d_prepare(dst, valid, src_valid)
            bound, bound_by = nn3d_bound_ms(Q, N, n_query, n_point)
            cbound, _ = compact_bound_ms(0 if src_valid is None else Q, N, n_point)
            search = lambda: K2.nn3d_search(src, plan)  # noqa: E731
            prepare = lambda: K2.nn3d_prepare(dst, valid, src_valid)  # noqa: E731
            row.update(kernel_ms=time_ms(search), graph_ms=graph_ms(search),
                       compact_ms=time_ms(prepare), compact_graph_ms=graph_ms(prepare),
                       plain_ms=time_ms(lambda: K2.nn3d_reference(src, dst, valid, src_valid),
                                        reps=10),
                       library_ms=time_ms(lambda: nn3d_library(src, dst, valid, src_valid),
                                          reps=10),
                       bound_us=bound * 1e3, bound_by=bound_by, compact_bound_us=cbound * 1e3)
        print(json.dumps(row), flush=True)
        rows[name] = row
    # K2 a full-width frame: 16 odometry and 16 closure searches, by each
    # timing (PR 2's 12.2 ms a frame was timed as kernel_ms)
    frame = {key: 16 * rows["odometry-masked"][key] + 16 * rows["closure-masked"][key]
             for key in ("kernel_ms", "graph_ms")}
    print(json.dumps({"kernel": "nn3d", "full_width_frame": frame}), flush=True)
    check_no_sync()
    main_shape = rows["odometry-masked"]
    k2 = {"name": "nn3d", "route": "cuda", "source": "rtabmap_tpu_torch/csrc/nn3d.cu",
          "replaces": "rtabmap_tpu/ops/pallas/nn3d.py:56", "max_abs_err": 0.0,
          "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
          "bound_ms": main_shape["bound_us"] * 1e-3, "bound_by": main_shape["bound_by"],
          "library_ms": main_shape["library_ms"]}
    # no one PyTorch call does the compaction (the plain version is a
    # nonzero, a gather and a concatenation)
    _, src, dst, valid, src_valid = next(c for c in cases if c[0] == "odometry-masked")
    cb, cb_by = compact_bound_ms(src.shape[0], dst.shape[0], int(valid.sum()))
    compact = {"name": "nn3d_compact", "route": "cuda",
               "source": "rtabmap_tpu_torch/csrc/nn3d.cu",
               "replaces": "rtabmap_tpu/ops/pallas/nn3d.py:56", "max_abs_err": 0.0,
               "ms": main_shape["compact_ms"],
               "plain_ms": time_ms(lambda: K2.nn3d_compact_reference(dst, valid, src_valid)),
               "bound_ms": cb, "bound_by": cb_by, "library_ms": None}
    return k2, compact


def check_no_sync():
    """A masked search, compaction included, under sync-debug "error": any
    host synchronization inside the wrappers raises."""
    _, scans = LM.sensor_sequence(2, noise=LIDAR_NOISE, device=torch.device("cuda"))
    (a, a_valid), (b, b_valid) = list(scans)
    a_mask, b_mask = voxel_filter(a, a_valid, 0.05), voxel_filter(b, b_valid, 0.05)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, i = K2.nn3d(b, a, a_mask, b_mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "nn3d", "sync_debug": "error", "synced": False,
                      "queries": b.shape[0]}), flush=True)


# -------------------------------------------------------------------- slice


def run_slice():
    """Two laps of the appearance-only tick on the card (tools/bow_laps.py);
    returns the vocabulary kernel's launches during the run."""
    K1.knn2.launches = 0
    res = bow_laps.run(torch.device("cuda"), FRAMES_PER_LAP, size=(640, 480))
    launches = K1.knn2.launches
    slam = res.slam
    mem = slam.memory
    for name, t in (("vocabulary slab", mem.vocab.slab), ("word flags", mem.vocab.word_valid),
                    ("node words", mem.node_words), ("word counts", mem.word_nw),
                    ("posterior", slam.bayes.posterior)):
        if t.device.type != "cuda":
            fail(f"{name} lies on {t.device}")
    quantize_calls = sum("TimingMem/Add new words/ms" in s.data for s in res.stats)
    if launches != quantize_calls or launches == 0:
        fail(f"vocab_knn2 launched {launches} times for {quantize_calls} quantize calls")
    for st in res.stats:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"statistic {k} = {v}")
    if res.lap2_same_view < LAP2_THRESHOLD:
        fail(f"lap 2 closed with the same viewpoint {res.lap2_same_view} times, "
             f"threshold {LAP2_THRESHOLD} (JAX CPU run: {JAX_LAP2_SAME_VIEW})")
    print(json.dumps({"slice": "bow_mapping", "resolution": [640, 480],
                      "lap2_threshold": LAP2_THRESHOLD,
                      "jax_cpu_lap2_same_view": JAX_LAP2_SAME_VIEW,
                      "vocab_knn2_launches": launches, **res.summary()}), flush=True)
    return launches


def run_lidar(n_azimuth: int, map_capacity: int) -> dict:
    """One LiDAR mapping run on the card (tools/lidar_mapping.py) over the
    slice's sequence at ``n_azimuth`` x 16; checks that every state tensor
    lies on the card and that K2 launched its search once for each search
    the tool asked for and its compaction once for each destination the
    tool prepared."""
    dev = torch.device("cuda")
    gt, scans = LM.sensor_sequence(LIDAR_FRAMES, n_azimuth=n_azimuth, noise=LIDAR_NOISE,
                                   device=dev)
    K2.nn3d_search.launches = K2.nn3d_prepare.launches = 0
    out = LM.run_lidar_mapping(scans, gt_poses=gt, device=dev, map_capacity=map_capacity)
    launches, compactions = K2.nn3d_search.launches, K2.nn3d_prepare.launches
    st = out["odometry"].state
    for name, t in (("map points", st.map_pts), ("map normals", st.map_nrm),
                    ("map flags", st.map_valid), ("odometry pose", st.pose),
                    ("graph poses", out["graph"].poses), ("graph information", out["graph"].edges_info),
                    ("voxel bricks", out["voxel_map"].bricks)):
        if t.device.type != "cuda":
            fail(f"{name} lies on {t.device}")
    if launches != out["nn3d_searches"] or launches == 0:
        fail(f"nn3d launched {launches} times for {out['nn3d_searches']} searches")
    if compactions != out["nn3d_plans"] or compactions == 0:
        fail(f"nn3d_compact launched {compactions} times for {out['nn3d_plans']} "
             "prepared destinations")
    poses = np.stack([out["poses"][i] for i in sorted(out["poses"])])
    if not (np.isfinite(poses).all() and np.isfinite(out["ate_slam"])):
        fail("non-finite poses or ATE")
    res = {"slice": "lidar_mapping", "points": n_azimuth * 16, "frames": LIDAR_FRAMES,
           "map_capacity": map_capacity,
           "nn3d_launches": launches, "nn3d_compact_launches": compactions,
           **LM.summary(out)}
    print(json.dumps(res), flush=True)
    return res


def run_lidar_slices() -> tuple:
    """The parity-width run against the JAX CPU numbers, then the full-width
    run against the ground truth; returns K2's search and compaction
    launches in the latter."""
    par = run_lidar(PARITY_AZIMUTH, 2048)
    if par["closures"] < int(0.9 * JAX_LIDAR_CLOSURES):
        fail(f"parity width: {par['closures']} closures, JAX CPU {JAX_LIDAR_CLOSURES}")
    if par["lost"] > JAX_LIDAR_LOST:
        fail(f"parity width: {par['lost']} lost frames, JAX CPU {JAX_LIDAR_LOST}")
    if par["ate_slam"] > JAX_LIDAR_ATE + 0.01:
        fail(f"parity width: ATE {par['ate_slam']:.4f} m, JAX CPU {JAX_LIDAR_ATE:.4f} m")
    full = run_lidar(VLP16_AZIMUTH, LM.VLP16_MAP_CAPACITY)
    if full["lost"] != 0 or full["nodes"] != LIDAR_FRAMES:
        fail(f"full width: {full['nodes']} nodes, {full['lost']} lost")
    if full["ate_slam"] > FULL_WIDTH_ATE:
        fail(f"full width: ATE {full['ate_slam']:.4f} m > {FULL_WIDTH_ATE} m")
    return full["nn3d_launches"], full["nn3d_compact_launches"]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    reports = build.build_all([K1.SOURCE, K2.SOURCE])
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(reports)}), flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}", file=sys.stderr)

    k1 = check_knn2()
    k2, k2c = check_nn3d()
    k1["launches"] = run_slice()
    k2["launches"], k2c["launches"] = run_lidar_slices()

    print(card)
    print(json.dumps({"kernels": [k1, k2, k2c]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

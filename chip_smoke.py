"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases — any failure ends the run with a non-zero exit code:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the path from ``rtabmap_tpu_torch/csrc``
   (one nvcc per source, all at once) into ``build/``;
3. kernels: holds each kernel against its plain PyTorch version on the card
   (vocabulary 2-NN at the main path's shape Q=400 x W=262144 and at a
   ragged Q=37 x W=5000; exact equality) and times kernel, plain version,
   one PyTorch library call of the same function, and the bound;
4. slice: the appearance-only BOWMapping tick — ``FeatureExtractor.extract``
   -> ``Rtabmap.process`` with RGBD/Enabled=false on cuda, 640x480 renders
   of two 150-frame laps, 400 keypoints, the default 262144-word
   vocabulary, 1024 node slots. Kernel launch counts are zeroed right
   before and read right after; lap 2 must close with lap-1 nodes of the
   same viewpoint at least as often as the threshold below.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from rtabmap_tpu_torch.ops.cuda import build
from rtabmap_tpu_torch.ops.cuda import vocab_knn as K1
from rtabmap_tpu_torch.tools import bow_laps

# H100 SXM dense peaks (NVIDIA data sheet): HBM bytes/s, int8 tensor op/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

FRAMES_PER_LAP = bow_laps.FRAMES_PER_LAP
# Lap-2 ticks that close with a lap-1 node of the same viewpoint (+-3
# frames): the JAX package's own CPU run of this sequence
# (scripts/jax_bow_laps.py) counts JAX_LAP2_SAME_VIEW. The port on the card
# must reach 90% of it: float sums run in another order on the card (blur
# products, likelihood reductions, atomics in the Bayes scatter), which can
# move a near-tie keypoint or hypothesis.
JAX_LAP2_SAME_VIEW = 97
LAP2_THRESHOLD = int(0.9 * JAX_LAP2_SAME_VIEW)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ------------------------------------------------------------------ kernels


def knn2_case(Q: int, W: int, seed: int):
    """Seeded +-1 slab with 30% invalid words and duplicated rows (ties),
    queries drawn half from the slab, one zero (invalid keypoint) row."""
    rng = np.random.default_rng(seed)
    slab = (rng.integers(0, 2, (W, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    dup = rng.integers(0, W, W // 10)
    slab[rng.integers(0, W, W // 10)] = slab[dup]
    valid = rng.random(W) >= 0.3
    q = (rng.integers(0, 2, (Q, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    q[: Q // 2] = slab[rng.integers(0, W, Q // 2)]
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


def knn2_bound_ms(Q: int, valid) -> tuple:
    """Least time for the work these inputs need: the valid words' rows
    read once, the queries and flags read once, the (Q,2) outputs written
    once; 2*Q*n_valid*256 int8 operations."""
    n_valid = int(valid.sum())
    W = valid.shape[0]
    bytes_ = Q * 256 + W + n_valid * 256 + Q * 2 * 8
    ops = 2.0 * Q * n_valid * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_knn2():
    rows, max_err = [], 0.0
    for Q, W, seed in ((400, 262144, 0), (37, 5000, 1)):
        q, slab, valid = knn2_case(Q, W, seed)
        d, i = K1.knn2(q, slab, valid)
        torch.cuda.synchronize()
        dr, ir = K1.knn2_reference(q, slab, valid)
        if not (torch.equal(d, dr) and torch.equal(i[:, 0], ir[:, 0])):
            bad = int(((d != dr).any(1) | (i[:, 0] != ir[:, 0])).sum())
            fail(f"vocab_knn2 disagrees with its plain version at Q={Q} W={W} "
                 f"on {bad} queries")
        if not torch.equal(i, ir):
            fail(f"vocab_knn2 rank-1 indices differ at Q={Q} W={W}")
        max_err = max(max_err, float((d - dr).abs().max()))
        bound, bound_by = knn2_bound_ms(Q, valid)
        row = {"kernel": "vocab_knn2", "Q": Q, "W": W, "equal": True,
               "kernel_ms": time_ms(lambda: K1.knn2(q, slab, valid)),
               "plain_ms": time_ms(lambda: K1.knn2_reference(q, slab, valid), reps=10),
               "library_ms": time_ms(lambda: knn2_library(q, slab, valid)),
               "bound_us": bound * 1e3, "bound_by": bound_by}
        print(json.dumps(row), flush=True)
        rows.append(row)
    main_shape = rows[0]
    return {"name": "vocab_knn2", "route": "cuda",
            "source": "rtabmap_tpu_torch/csrc/vocab_knn.cu",
            "replaces": "rtabmap_tpu/ops/pallas/vocab_knn.py:80",
            "max_abs_err": max_err, "ms": main_shape["kernel_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] * 1e-3,
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"]}


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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    reports = build.build_all([K1.SOURCE])
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(reports)}), flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}", file=sys.stderr)

    k1 = check_knn2()
    k1["launches"] = run_slice()

    print(card)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""K2's compaction at the edges of its tiles: one case list for the CPU test
of the plain version, the card test of the kernel and ``chip_smoke.py``.

A compaction block takes ``COMPACT_TILE`` = T flags; a plan whose points
and queries span at most ``COMPACT_ONE_PASS_TILES`` = 4 tiles each takes
one launch, a larger one two. Cases: destinations of T-1, T, T+1, 3T,
3T+1, 4T and 4T+1 points with every point valid (no query mask), none or
only the last one (64 queries, a 70% mask); query masks of T-1, T+1, 3T+1
and 4T+1 flags all true and all false (1000 points, 70% valid); 3T+1 and
4T+1 points with T+1 queries, half of each valid. ``on_device`` places
flags at a byte offset into a larger tensor, so that a card run can start
them off the 16-byte alignment the kernel's vector loads want.
"""
import numpy as np
import torch

from rtabmap_tpu_torch.ops.cuda.nn3d import COMPACT_ONE_PASS_TILES, COMPACT_TILE as T

ONE_PASS = COMPACT_ONE_PASS_TILES * T
POINT_SIZES = (T - 1, T, T + 1, 3 * T, 3 * T + 1, ONE_PASS, ONE_PASS + 1)
QUERY_SIZES = (T - 1, T + 1, 3 * T + 1, ONE_PASS + 1)
NAMES = ([f"points-{n}-{p}" for n in POINT_SIZES for p in ("all", "none", "last")]
         + [f"queries-{n}-{p}" for n in QUERY_SIZES for p in ("all", "none")]
         + [f"half-{n}" for n in (3 * T + 1, ONE_PASS + 1)])


def two_pass(flags, q_flags) -> bool:
    """Whether the kernel runs the count pass for these flags."""
    tiles = max(-(-flags.size // T), 0 if q_flags is None else -(-q_flags.size // T))
    return tiles > COMPACT_ONE_PASS_TILES


def flag_case(name):
    """(points (N,3) float32, point flags (N,), query flags (Q,) or None),
    numpy, made from a seed of the case's name."""
    rng = np.random.default_rng(NAMES.index(name))
    kind, *rest = name.split("-")
    if kind == "points":
        n, pattern = int(rest[0]), rest[1]
        q_flags = None if pattern == "all" else rng.random(64) >= 0.3
        flags = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                 "last": np.arange(n) == n - 1}[pattern]
    elif kind == "queries":
        n, pattern = int(rest[0]), rest[1]
        flags = rng.random(1000) >= 0.3
        q_flags = np.full(n, pattern == "all")
    else:
        flags, q_flags = rng.random(int(rest[0])) >= 0.5, rng.random(T + 1) >= 0.5
    return rng.normal(size=(flags.size, 3)).astype(np.float32), flags, q_flags


def on_device(flags, device, offset: int = 0):
    """numpy flags (or None) as a bool tensor on ``device`` that starts
    ``offset`` bytes into a larger one."""
    if flags is None:
        return None
    t = torch.zeros(flags.size + offset, dtype=torch.bool, device=device)
    t[offset:] = torch.from_numpy(flags).to(device)
    return t[offset:]


def expected(points, flags, q_flags):
    """The compaction by numpy: (dst4 (np,4), dlist (np,), qlist (Q,) or
    None, (np, nq)): the valid points in order with a zero fourth lane,
    their indices, the valid queries in order then the masked ones."""
    dlist = np.flatnonzero(flags)
    dst4 = np.concatenate([points[dlist], np.zeros((dlist.size, 1), np.float32)], 1)
    if q_flags is None:
        return dst4, dlist, None, (dlist.size, 0)
    qlist = np.concatenate([np.flatnonzero(q_flags), np.flatnonzero(~q_flags)])
    return dst4, dlist, qlist, (dlist.size, int(q_flags.sum()))

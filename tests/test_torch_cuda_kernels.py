"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips without
a card. This file imports no JAX; on the GPU machine run it without the
suite's conftest (which configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerance: none. The vocabulary 2-NN is integer arithmetic and both
versions rank in (dist, idx) order; the 3-D 1-NN rounds each operation on
its own in the same order on both sides and takes the (dist, idx)
lexicographic minimum. Cases: K1 at the path's shapes, at its valid-prefix
call (the BOW and RGB-D slices' end states), and at edge tiles (Q and W off every tile multiple, with ties from
duplicated rows); K2 at the path's shapes and edges, each with and without
a query mask, and its compaction."""
import numpy as np
import pytest
import torch

from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from rtabmap_tpu_torch.ops.cuda import vocab_knn as V

# (Q, W, invalid share, rows duplicated to force ties)
CASES = {
    "main-path": (400, 262144, 0.3, True),
    "ragged": (37, 5000, 0.3, True),
    "no-valid-word": (64, 1024, 1.0, False),
    "one-row": (1, 1, 0.0, False),
    "one-tile": (64, 64, 0.0, False),
}


def _knn2_inputs(Q, W, invalid, dup, seed):
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 2, (W, 256)) * 2 - 1).astype(np.int8)
    if dup:
        s[rng.integers(0, W, max(1, W // 10))] = s[rng.integers(0, W, max(1, W // 10))]
    valid = rng.random(W) >= invalid
    q = (rng.integers(0, 2, (Q, 256)) * 2 - 1).astype(np.int8)
    q[: Q // 2] = s[rng.integers(0, W, Q // 2)]
    q[-1] = 0
    return [torch.from_numpy(a).cuda() for a in (q, s, valid)]


def _knn2_equal(args):
    before = V.knn2.launches
    d, i = V.knn2(*args)
    torch.cuda.synchronize()
    assert V.knn2.launches == before + 1
    dr, ir = V.knn2_reference(*args)
    assert torch.equal(d, dr)
    assert torch.equal(i, ir)
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_knn2_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _knn2_equal(_knn2_inputs(*CASES[name], seed=len(name)))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 15, 17, 65, 400, 513])
@pytest.mark.parametrize("W", [1, 31, 129, 5000])
def test_knn2_kernel_edge_tiles(Q, W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _knn2_equal(_knn2_inputs(Q, W, 0.2, True, seed=Q * 7919 + W))


@pytest.mark.cuda
def test_knn2_kernel_valid_prefix():
    """The dictionary's call: the valid prefix of the slab gives what the
    whole slab gives (the BOW cell's end state: 31853 of 262144 words)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, s, _ = _knn2_inputs(400, 262144, 0.0, True, seed=3)
    valid = torch.arange(262144, device="cuda") < 31853
    d_full, i_full = _knn2_equal([q, s, valid])
    d, i = _knn2_equal([q, s[:31853], valid[:31853]])
    assert torch.equal(d, d_full) and torch.equal(i, i_full)


# The RGB-D slice's quantize calls: (keypoints a frame, words in the
# vocabulary at the end of the run) of the parity sequence (384 keypoints)
# and of the full-width sequence (512 keypoints), from the JAX package's
# CPU runs (scripts/jax_rgbd_laps.py); the dictionary passes that prefix.
RGBD_PREFIX = {"parity": (384, 6709), "full-width": (512, 24054)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RGBD_PREFIX))
def test_knn2_kernel_rgbd_slice_shapes(name):
    """K1 at the RGB-D slice's shapes: Q keypoints against the valid
    prefix the run ends with, and one row past it (a word appended), each
    equal to the plain version and to the whole slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Q, n_words = RGBD_PREFIX[name]
    q, s, _ = _knn2_inputs(Q, 262144, 0.0, True, seed=Q)
    for n in (n_words, n_words + 1):
        valid = torch.arange(262144, device="cuda") < n
        d_full, i_full = _knn2_equal([q, s, valid])
        d, i = _knn2_equal([q, s[:n], valid[:n]])
        assert torch.equal(d, d_full) and torch.equal(i, i_full)


# (Q, N, invalid share, duplicated points and queries on points)
NN3D_CASES = {
    "odometry": (28800, 2048, 0.0, False),
    "closure": (28800, 28800, 0.6, False),
    "ragged": (37, 5000, 0.3, True),
    "no-valid-point": (64, 1000, 1.0, False),
    "one-point": (1, 1, 0.0, False),
}


def _nn3d_inputs(name):
    Q, N, invalid, dup = NN3D_CASES[name]
    rng = np.random.default_rng(len(name))
    dst = rng.normal(0, 3, (N, 3)).astype(np.float32)
    src = rng.normal(0, 3, (Q, 3)).astype(np.float32)
    if dup:
        dst[rng.integers(0, N, N // 10)] = dst[rng.integers(0, N, N // 10)]
        src[: Q // 2] = dst[rng.integers(0, N, Q // 2)]
    valid = rng.random(N) >= invalid
    src_valid = rng.random(Q) >= 0.3
    return [torch.from_numpy(a).cuda() for a in (src, dst, valid, src_valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NN3D_CASES))
def test_nn3d_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, valid, _ = _nn3d_inputs(name)
    before = K2.nn3d_search.launches
    d, i = K2.nn3d(src, dst, valid)
    torch.cuda.synchronize()
    assert K2.nn3d_search.launches == before + 1
    dr, ir = K2.nn3d_reference(src, dst, valid)
    assert torch.equal(d, dr)
    assert torch.equal(i, ir)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NN3D_CASES) + ["no-valid-query", "one-of-each"])
def test_nn3d_kernel_query_mask(name):
    """With a 30% query mask (all masked for no-valid-query; one valid
    query and one valid point for one-of-each): equal to the plain
    version, (+inf, 0) on masked queries; the compaction equals its plain
    version; one plan serves several searches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, dst, valid, src_valid = _nn3d_inputs("ragged" if name in (
        "no-valid-query", "one-of-each") else name)
    if name == "no-valid-query":
        src_valid = torch.zeros_like(src_valid)
    if name == "one-of-each":
        src_valid = torch.arange(src.shape[0], device="cuda") == 20
        valid = torch.arange(dst.shape[0], device="cuda") == 4321
    before = (K2.nn3d_prepare.launches, K2.nn3d_search.launches)
    plan = K2.nn3d_prepare(dst, valid, src_valid)
    for shift in (0.0, 0.25):
        moved = src + shift
        d, i = K2.nn3d_search(moved, plan)
        torch.cuda.synchronize()
        dr, ir = K2.nn3d_reference(moved, dst, valid, src_valid)
        assert torch.equal(d, dr)
        assert torch.equal(i, ir)
        assert torch.all(torch.isinf(d[~src_valid])) and torch.all(i[~src_valid] == 0)
    assert (K2.nn3d_prepare.launches, K2.nn3d_search.launches) == (before[0] + 1,
                                                                   before[1] + 2)
    d4, dl, ql, counts = K2.nn3d_compact_reference(dst, valid, src_valid)
    assert plan.counts.cpu().tolist() == counts.tolist()
    assert torch.equal(plan.dst4[:d4.shape[0]], d4)
    assert torch.equal(plan.dlist[:d4.shape[0]], dl)
    assert torch.equal(plan.qlist, ql)

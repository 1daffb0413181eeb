"""Vocabulary 2-NN: the port's knn2 (its plain version on CPU tensors)
against the JAX Pallas kernel in interpret mode and the JAX blocked search
(the kernel itself is held against the plain version on the card in
tests/test_torch_cuda_kernels.py).

Tolerance: none. Distances are integers / 2 and must agree exactly below
1e8; above it each side reports "no neighbour" (the port exactly 1e9, the
Pallas kernel 1e9 + dist), compared only as "> 1e8". Rank-0 indices agree
exactly (both sides break ties toward the lower index)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.ops.matching import knn_blocked
from rtabmap_tpu.ops.pallas.vocab_knn import pallas_knn2
from rtabmap_tpu_torch.ops.cuda import vocab_knn as V
from torch_port_threads import one_torch_thread  # noqa: F401


def _signs(rng, n, d=256):
    return (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.int8)


def _case(name):
    rng = np.random.default_rng(["main", "empty", "single", "ragged", "ties"].index(name))
    if name == "main":      # tests/test_pallas_kernels.py's case
        Q, W, block = 128, 2048, 512
        valid = np.ones(W, bool)
        valid[50:300] = False
    elif name == "empty":   # no valid word at all
        Q, W, block = 128, 1024, 512
        valid = np.zeros(W, bool)
    elif name == "single":  # one slab block
        Q, W, block = 128, 512, 512
        valid = np.ones(W, bool)
    elif name == "ragged":  # shapes the TPU kernel does not take
        Q, W, block = 100, 1000, 256
        valid = rng.random(W) > 0.2
    else:                   # duplicated rows: exact distance ties everywhere
        Q, W, block = 128, 2048, 512
        valid = rng.random(W) > 0.1
    s = _signs(rng, W)
    if name == "ties":
        s = np.tile(_signs(rng, 64), (W // 64, 1))
    q = _signs(rng, Q)
    q[: Q // 2] = s[rng.integers(0, W, Q // 2)]
    q[-1] = 0  # an invalid keypoint's zero row
    return q, s, valid, block


def _check(d_port, i_port, d_ref, i_ref, rank1_index=True):
    d_port, i_port = d_port.numpy(), i_port.numpy()
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    real = d_ref < 1e8
    np.testing.assert_array_equal(d_port[real], d_ref[real])
    assert np.all(d_port[~real] > 1e8) and np.all(d_port[~real] == 1e9)
    has0 = real[:, 0]
    np.testing.assert_array_equal(i_port[has0, 0], i_ref[has0, 0])
    if rank1_index:
        has1 = real[:, 1]
        np.testing.assert_array_equal(i_port[has1, 1], i_ref[has1, 1])


@pytest.mark.parametrize("name", ["main", "empty", "single", "ragged", "ties"])
def test_knn2_matches_jax_blocked(name):
    q, s, valid, block = _case(name)
    d, i = V.knn2(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(valid))
    dr, ir = knn_blocked(jnp.asarray(q), jnp.asarray(s), k=2, block=block,
                         base_valid=jnp.asarray(valid))
    # knn_blocked ranks both neighbours in (dist, idx) order
    _check(d, i, dr, ir, rank1_index=True)


@pytest.mark.parametrize("name", ["main", "empty", "single", "ties"])
def test_knn2_matches_pallas_interpret(name):
    q, s, valid, block = _case(name)
    d, i = V.knn2(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(valid))
    dp, ip = pallas_knn2(jnp.asarray(q), jnp.asarray(s), jnp.asarray(valid),
                         block=block, interpret=True)
    # the Pallas merge may rank a later block's equal rank-1 distance first
    _check(d, i, dp, ip, rank1_index=False)


def test_knn2_rejects_bad_inputs():
    q = torch.zeros((4, 128), dtype=torch.int8)
    s = torch.zeros((8, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        V.knn2(q, s, torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        V.knn2(torch.zeros((4, 256), dtype=torch.int8), s, torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError):
        V.knn2(torch.zeros((4, 256), dtype=torch.float32), s, torch.ones(8, dtype=torch.bool))


@pytest.mark.parametrize("n_valid", [1, 77, 1000])
def test_knn2_valid_prefix_matches_full_slab(n_valid):
    """The dictionary's call: when the valid words are the prefix
    [0, n_valid), searching the prefix gives the whole slab's answer, and
    the JAX blocked search's."""
    rng = np.random.default_rng(n_valid)
    s = _signs(rng, 2048)
    valid = np.arange(2048) < n_valid
    q = _signs(rng, 100)
    q[:50] = s[rng.integers(0, n_valid, 50)]
    q[-1] = 0
    d, i = V.knn2(torch.from_numpy(q), torch.from_numpy(s[:n_valid]),
                  torch.from_numpy(valid[:n_valid]))
    df, i_f = V.knn2(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(valid))
    assert torch.equal(d, df) and torch.equal(i, i_f)
    dr, ir = knn_blocked(jnp.asarray(q), jnp.asarray(s), k=2, block=512,
                         base_valid=jnp.asarray(valid))
    _check(d, i, dr, ir, rank1_index=True)

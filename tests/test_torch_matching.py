"""NNDR descriptor matching: the port's match_nndr (plain and window mode),
match_nndr_bidir, cross_check and match_mutual_nndr against the JAX twins
on the same seeded +-1 descriptors.

Tolerance: none. Hamming distances are integers (exact in float32 on both
sides) and every index and flag must agree exactly. The descriptor sets
plant exact ties: duplicated rows give equal best and second distances,
which both sides must break toward the lowest index."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.ops import matching as JM
from rtabmap_tpu_torch.ops import matching as M
from torch_port_threads import one_torch_thread  # noqa: F401


def _case(seed, ka=96, kb=120, batch=()):
    rng = np.random.default_rng(seed)
    bank = (rng.integers(0, 2, (40, 256)) * 2 - 1).astype(np.int8)
    a = bank[rng.integers(0, 40, (*batch, ka))]
    b = bank[rng.integers(0, 40, (*batch, kb))]       # many duplicated rows: ties
    flip = rng.random(a.shape) < 0.05                  # near-ties around them
    a = np.where(flip, -a, a).astype(np.int8)
    va = rng.random((*batch, ka)) > 0.1
    vb = rng.random((*batch, kb)) > 0.1
    a[~va] = 0                                         # invalid rows are zero
    return a, va, b, vb


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(m_port, m_jax):
    np.testing.assert_array_equal(m_port.idx.numpy(), np.asarray(m_jax.idx))
    np.testing.assert_array_equal(m_port.dist.numpy(), np.asarray(m_jax.dist))
    np.testing.assert_array_equal(m_port.second.numpy(), np.asarray(m_jax.second))
    np.testing.assert_array_equal(m_port.valid.numpy(), np.asarray(m_jax.valid))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_nndr_and_bidir_with_ties(seed):
    a, va, b, vb = _case(seed)
    for nndr in (0.8, 1.0):   # 1.0 accepts exact best == second ties
        _same(M.match_nndr(_t(a), _t(va), _t(b), _t(vb), nndr=nndr),
              JM.match_nndr(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                            jnp.asarray(vb), nndr=nndr))
        p_ab, p_ba = M.match_nndr_bidir(_t(a), _t(va), _t(b), _t(vb), nndr=nndr)
        j_ab, j_ba = JM.match_nndr_bidir(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                         jnp.asarray(vb), nndr=nndr)
        _same(p_ab, j_ab)
        _same(p_ba, j_ba)
        np.testing.assert_array_equal(M.cross_check(p_ab, p_ba).numpy(),
                                      np.asarray(JM.cross_check(j_ab, j_ba)))
        _same(M.match_mutual_nndr(_t(a), _t(va), _t(b), _t(vb), nndr),
              JM.match_mutual_nndr(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                   jnp.asarray(vb), nndr))
    # max_dist gate
    _same(M.match_nndr(_t(a), _t(va), _t(b), _t(vb), max_dist=100.0),
          JM.match_nndr(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
                        max_dist=100.0))


def test_match_nndr_window_mode():
    a, va, b, vb = _case(3)
    rng = np.random.default_rng(3)
    guess_uv = (rng.random((a.shape[0], 2)) * [320, 240]).astype(np.float32)
    uv_b = (rng.random((b.shape[0], 2)) * [320, 240]).astype(np.float32)
    for window in (20.0, 60.0):
        _same(M.match_nndr(_t(a), _t(va), _t(b), _t(vb), guess_uv=_t(guess_uv),
                           uv_b=_t(uv_b), window=window),
              JM.match_nndr(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                            jnp.asarray(vb), guess_uv=jnp.asarray(guess_uv),
                            uv_b=jnp.asarray(uv_b), window=jnp.float32(window)))


def test_batched_matching_equals_per_item():
    """A leading candidate axis (the batched registration's form) gives the
    JAX result of each item."""
    a, va, b, vb = _case(4, batch=(3,))
    p_ab, p_ba = M.match_nndr_bidir(_t(a), _t(va), _t(b), _t(vb))
    mutual = M.cross_check(p_ab, p_ba)
    for k in range(3):
        j_ab, j_ba = JM.match_nndr_bidir(jnp.asarray(a[k]), jnp.asarray(va[k]),
                                         jnp.asarray(b[k]), jnp.asarray(vb[k]))
        _same(M.Matches(*(x[k] for x in p_ab)), j_ab)
        _same(M.Matches(*(x[k] for x in p_ba)), j_ba)
        np.testing.assert_array_equal(mutual[k].numpy(),
                                      np.asarray(JM.cross_check(j_ab, j_ba)))

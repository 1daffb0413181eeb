"""Vocabulary, likelihoods and the Bayes filter: the port on the CPU against
the JAX package on the same seeded inputs.

Tolerances, with their reasons:
- word ids, n_words, neighbour tables, state round trips: exact (integer);
- likelihoods: 1e-5 relative — float32 sums over node words in another
  order (and log10 of another library);
- Bayes posterior: 1e-6 absolute — the prediction scatter (index_add_)
  sums in another order than the JAX compare-reduce / scatter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.bayes import filter as JB
from rtabmap_tpu.datasets.synthetic import FeatureWorld as JWorld
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.vocab import dictionary as JD
from rtabmap_tpu_torch.bayes import filter as TB
from rtabmap_tpu_torch.vocab import dictionary as TD
from torch_port_threads import one_torch_thread  # noqa: F401

CAP = 4096


def _frames(ways=tuple(range(8)) + (0, 1, 2, 3)):
    """FeatureWorld frames (by default 8 ways, then 4 revisits) with seeded
    bit flips so that the NNDR test both matches and creates words."""
    cam = JC.CameraModel.make(300.0, 300.0, 160.0, 120.0, 320, 240)
    world = JWorld(cam, n_ways=12, K=128)
    rng = np.random.default_rng(5)
    out = []
    for i, w in enumerate(ways):
        fr = world.frame(w, i)
        desc = np.asarray(fr.desc).copy()
        flips = rng.random(desc.shape) < 0.04
        desc[flips] *= -1
        valid = rng.random(desc.shape[0]) > 0.1
        desc[~valid] = 0
        out.append((desc, valid))
    return out


def test_incremental_quantize_matches():
    jv = JD.VWDictionary(capacity=CAP)
    tv = TD.VWDictionary(capacity=CAP, device="cpu")
    for desc, valid in _frames():
        wj, nj = jv.quantize(jnp.asarray(desc), jnp.asarray(valid))
        wt, nt = tv.quantize(torch.from_numpy(desc), torch.from_numpy(valid))
        np.testing.assert_array_equal(wt, np.asarray(wj))
        np.testing.assert_array_equal(nt, np.asarray(nj))
        assert tv.n_words == jv.n_words
    assert 0 < tv.n_words < sum(int(v.sum()) for _, v in _frames())
    st_j, st_t = jv.state_dict(), tv.state_dict()
    for k in ("slab", "word_valid"):
        np.testing.assert_array_equal(st_t[k], st_j[k])


def test_from_state_round_trip():
    frames = _frames()
    jv = JD.VWDictionary(capacity=CAP)
    for desc, valid in frames[:8]:
        jv.quantize(jnp.asarray(desc), jnp.asarray(valid))
    tv = TD.VWDictionary.from_state(jv.state_dict(), device="cpu")
    assert tv.n_words == jv.n_words and tv.nndr == jv.nndr
    for desc, valid in frames[8:]:
        wj, _ = jv.quantize(jnp.asarray(desc), jnp.asarray(valid))
        wt, _ = tv.quantize(torch.from_numpy(desc), torch.from_numpy(valid))
        np.testing.assert_array_equal(wt, np.asarray(wj))
    np.testing.assert_array_equal(tv.state_dict()["slab"], jv.state_dict()["slab"])


def test_quantize_prefix_matches_full_slab_and_jax():
    """The dictionary scans only the valid prefix [0, n_words) of its slab:
    over a 20-frame incremental sequence the prefix search gives the
    full-slab search's neighbours and new-word flags, the JAX
    ``_quantize_kernel``'s, and the JAX dictionary's word ids, new-word
    flags and word count, all exactly."""
    jv = JD.VWDictionary(capacity=CAP)
    tv = TD.VWDictionary(capacity=CAP, device="cpu")
    nndr = torch.tensor(tv.nndr)
    for desc, valid in _frames(tuple(range(12)) + tuple(range(8))):
        dt, vt = torch.from_numpy(desc), torch.from_numpy(valid)
        n = max(tv.n_words, 1)
        i_pre, new_pre = TD._quantize_kernel(dt, vt, tv.slab[:n], tv.word_valid[:n], nndr)
        i_full, new_full = TD._quantize_kernel(dt, vt, tv.slab, tv.word_valid, nndr)
        i_j, new_j = JD._quantize_kernel(jnp.asarray(desc), jnp.asarray(valid), jv.slab,
                                         jv.word_valid, jnp.float32(jv.nndr))
        assert torch.equal(i_pre, i_full) and torch.equal(new_pre, new_full)
        np.testing.assert_array_equal(i_pre.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(new_pre.numpy(), np.asarray(new_j))
        wj, nj = jv.quantize(jnp.asarray(desc), jnp.asarray(valid))
        wt, nt = tv.quantize(dt, vt)
        np.testing.assert_array_equal(wt, np.asarray(wj))
        np.testing.assert_array_equal(nt, np.asarray(nj))
        assert tv.n_words == jv.n_words
    assert 0 < tv.n_words < CAP


def test_from_state_rejects_valid_word_past_n_words():
    tv = TD.VWDictionary(capacity=64, device="cpu")
    desc, valid = _frames()[0]
    tv.quantize(torch.from_numpy(desc[:16]), torch.from_numpy(valid[:16]))
    st = tv.state_dict()
    TD.VWDictionary.from_state(st, device="cpu")        # consistent: loads
    st["word_valid"] = st["word_valid"].copy()
    st["word_valid"][tv.n_words + 3] = True
    with pytest.raises(ValueError):
        TD.VWDictionary.from_state(st, device="cpu")
    with pytest.raises(RuntimeError):                   # n_words must be current
        tv.quantize_async(torch.from_numpy(desc[:4]), torch.from_numpy(valid[:4]))
        tv.quantize_async(torch.from_numpy(desc[:4]), torch.from_numpy(valid[:4]))


def _likelihood_inputs(seed=0, N=24, K=48, W=96):
    rng = np.random.default_rng(seed)
    node_words = rng.integers(0, W, (N, K)).astype(np.int32)
    node_words[rng.random((N, K)) < 0.2] = -1
    node_words[3] = -1                       # an empty node
    node_valid = rng.random(N) > 0.15
    q = rng.integers(0, W, K).astype(np.int32)
    q[rng.random(K) < 0.2] = -1
    word_nw = np.zeros(W, np.float32)
    for row in node_words[node_valid]:
        word_nw[np.unique(row[row >= 0])] += 1
    return q, node_words, node_valid, word_nw


@pytest.mark.parametrize("seed", [0, 1])
def test_likelihoods_match(seed):
    q, nw, nv, wnw = _likelihood_inputs(seed)
    n_places = float(nv.sum())
    lj = np.array(JD.tfidf_likelihood(jnp.asarray(q), jnp.asarray(nw), jnp.asarray(nv),
                                        jnp.asarray(wnw), jnp.float32(n_places), wnw.shape[0]))
    lt = TD.tfidf_likelihood(torch.from_numpy(q), torch.from_numpy(nw), torch.from_numpy(nv),
                             torch.from_numpy(wnw), n_places, wnw.shape[0]).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    assert np.count_nonzero(lj) > 5
    sj = np.asarray(JD.similarity_likelihood(jnp.asarray(q), jnp.asarray(nw), jnp.asarray(nv)))
    st = TD.similarity_likelihood(torch.from_numpy(q), torch.from_numpy(nw),
                                  torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=0)
    aj, vj = JD.adjust_likelihood(jnp.asarray(lj), jnp.asarray(nv))
    at, vt = TD.adjust_likelihood(torch.from_numpy(lj), torch.from_numpy(nv))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)


def _graph(rng, n_slots, n_links):
    links = [tuple(rng.integers(0, n_slots, 2)) for _ in range(n_links)]
    links += [(i, i + 1) for i in range(0, n_slots - 1, 2)]
    return [(int(a), int(b)) for a, b in links]


def test_neighbor_tables_match():
    rng = np.random.default_rng(3)
    N, depth, kn = 40, 8, 17
    links = _graph(rng, N, 30)
    for a, b in zip(JB.build_neighbor_table(links, N, depth, kn),
                    TB.build_neighbor_table(links, N, depth, kn)):
        np.testing.assert_array_equal(b, a)
    tj = JB.IncrementalNeighborTable(N, depth, kn)
    tt = TB.IncrementalNeighborTable(N, depth, kn)
    for step in range(200):
        op = rng.integers(0, 4)
        a, b = (int(x) for x in rng.integers(0, N, 2))
        for t in (tj, tt):
            (t.add_node(a) if op == 0 else t.remove_node(a) if op == 1
             else t.add_edge(a, b) if op == 2 else t.remove_edge(a, b))
        if step % 25 == 0:
            for x, y in zip(tj.flush(), tt.flush()):
                np.testing.assert_array_equal(y, x)
    nv = rng.random(N) > 0.2
    kernel = JB.DEFAULT_PREDICTION_LC
    np.testing.assert_array_equal(
        TB.prediction_matrix(*tt.flush(), nv, kernel),
        JB.prediction_matrix(*tj.flush(), nv, kernel))


@pytest.mark.parametrize("N", [40, 2056], ids=["compare-form", "scatter-form"])
def test_predict_and_update_matches(N):
    rng = np.random.default_rng(N)
    nbr_idx, nbr_margin = JB.build_neighbor_table(_graph(rng, N, N), N, 8, 17)
    post = rng.random(N + 1).astype(np.float32)
    post /= post.sum()
    lik = (rng.random(N) * 3).astype(np.float32)
    valid = rng.random(N) > 0.1
    kernel = JB.DEFAULT_PREDICTION_LC
    pj = np.asarray(JB._predict_and_update(
        jnp.asarray(post), jnp.asarray(lik), jnp.float32(1.7), jnp.asarray(nbr_idx),
        jnp.asarray(nbr_margin), jnp.asarray(valid), jnp.asarray(kernel), jnp.float32(0.9)))
    pt = TB._predict_and_update(
        torch.from_numpy(post), torch.from_numpy(lik), torch.tensor(1.7),
        torch.from_numpy(nbr_idx), torch.from_numpy(nbr_margin), torch.from_numpy(valid),
        torch.from_numpy(kernel), torch.tensor(0.9)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
    assert abs(pt.sum() - 1.0) < 1e-5

"""Pose-graph optimization, dense and matrix-free (PCG): the port
(device="cpu") against the JAX package on a noisy planar ring with loop
closures and one wrong closure, on the 500-node two-session merge of
tests/test_pose_graph.py, and through ``optimize_poses_dict``.

Tolerances and why: residual Jacobians within 1e-5 (the port's closed
form against the JAX twin's forward-mode autodiff of the same float32
SE(3) residual; in float64 the closed form equals PyTorch's own autodiff
of the port's residual to 1e-8, the series cut of its coefficients); optimized poses within 1e-3 and the final chi2 within 1e-3
relative (20 LM iterations of a float32 Cholesky of a 144 x 144 system
whose diagonal spans 1 .. 1e8 amplify ulp differences). PCG on the ring:
poses within 1e-4 and chi2 within 1e-4 relative (80 CG iterations of
float32 sums in another order; measured 1.5e-6). The H x product within
1e-4 relative. The 500-node merge, whose information spans 1e-6 .. 1e8
(float32 CG on a system that ill-conditioned moves with the order of
its sums): the port holds the twin test's own bounds, its chi2 is within
10% of the twin's, and the sessions' offset at the closure-constrained nodes
within 1 cm of the twin's (measured 3.7% and 0.2 mm; after 24 LM steps
neither side has converged in absolute position: both chains are still
stretched alike, metres from the ground truth at their far ends, and
their positions differ by up to 4 cm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.optim import pose_graph as JPG
from rtabmap_tpu_torch.optim import pose_graph as PG
from torch_port_threads import one_torch_thread  # noqa: F401


def _pose(xi):
    """(6,) [t, rotation vector] -> (3,4) float64, Rodrigues in numpy."""
    t, w = np.asarray(xi[:3], float), np.asarray(xi[3:], float)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) if th < 1e-12 else (np.eye(3) + np.sin(th) / th * K
                                       + (1 - np.cos(th)) / th ** 2 * K @ K)
    return np.concatenate([R, t[:, None]], axis=1)


def _mul(A, B):
    return np.concatenate([A[:, :3] @ B[:, :3], (A[:, :3] @ B[:, 3] + A[:, 3])[:, None]], axis=1)


def _inv(A):
    return np.concatenate([A[:, :3].T, (-A[:, :3].T @ A[:, 3])[:, None]], axis=1)


def _ring(n=24, seed=0):
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    gt = [_pose([3 * np.cos(a), 3 * np.sin(a), 0, 0, 0, a + np.pi / 2]) for a in ang]
    ef = list(range(n - 1)) + [0, 5, 2, 8]
    et = list(range(1, n)) + [n - 1, 17, 14, 20]
    noise = rng.normal(0, [0.02, 0.02, 0.005, 0.002, 0.002, 0.01], (len(ef), 6))
    meas = [_mul(_mul(_inv(gt[f]), gt[t]), _pose(e)) for f, t, e in zip(ef, et, noise)]
    meas[-1] = _mul(meas[-1], _pose([1.0, -0.5, 0, 0, 0, 0.4]))   # a wrong closure
    info = np.tile(np.eye(6, dtype=np.float32) * 100, (len(ef), 1, 1))
    info[n - 1:] *= 0.5
    init = [gt[0]]                          # dead reckoning on the odometry edges
    for k in range(n - 1):
        init.append(_mul(init[-1], meas[k]))
    switch = np.arange(len(ef)) >= n - 1
    return (np.stack(init).astype(np.float32), np.array(ef), np.array(et),
            np.stack(meas).astype(np.float32), info, switch)


def test_edge_jacobians_match_jax():
    init, ef, et, meas, _, _ = _ring()
    r, Ji, Jj = PG._edge_residual_jac(torch.from_numpy(init[ef]), torch.from_numpy(init[et]),
                                      torch.from_numpy(meas))
    rj, Jij, Jjj = jax.jit(jax.vmap(JPG._edge_residual_jac))(jnp.asarray(init[ef]), jnp.asarray(init[et]),
                                                    jnp.asarray(meas))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Jij), atol=1e-5)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jjj), atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "robust"])
def test_optimize_dense_matches_jax(mode):
    """'robust': the Huber kernel on every edge and DCS on the closures
    (switchable, with the annealed phi), one solve."""
    init, ef, et, meas, info, switch = _ring()
    kw = {"robust": mode == "robust"}
    gj = JPG.make_graph(jnp.asarray(init), jnp.asarray(ef, jnp.int32), jnp.asarray(et, jnp.int32),
                        jnp.asarray(meas), jnp.asarray(info))
    gt = PG.make_graph(torch.from_numpy(init), ef, et, meas, info)
    oj, cj = JPG.optimize(gj, iters=20,
                          switch_mask=jnp.asarray(switch) if mode == "robust" else None, **kw)
    ot, ct = PG.optimize(gt, iters=20,
                         switch_mask=torch.from_numpy(switch) if mode == "robust" else None, **kw)
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses), atol=1e-3)
    assert abs(float(ct) - float(cj)) <= 1e-3 * abs(float(cj))
    np.testing.assert_allclose(float(PG.graph_chi2(gt)), float(JPG.graph_chi2(gj)), rtol=1e-5)
    lt, at = PG.edge_errors(ot)
    lj, aj = JPG.edge_errors(oj)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-2, atol=1e-3)
    assert float(ct) < 0.5 * float(PG.graph_chi2(gt))


def _priors(init):
    """xyz-only priors (the GPS role) on every third node, at its dead
    reckoning position shifted by 5 cm."""
    idx = np.arange(0, init.shape[0], 3)
    meas = init[idx].copy()
    meas[:, 0, 3] += 0.05
    info = np.zeros((len(idx), 6, 6), np.float32)
    info[:, :3, :3] = np.eye(3) * 100.0
    return idx, meas, info


def test_hx_product_matches_jax():
    """The matrix-free H x product against the twin's on random Jacobians,
    information (diagonal 1 .. 1e4), damping and a random x."""
    rng = np.random.default_rng(3)
    N, E = 16, 40
    ef, et = rng.integers(0, N, E), rng.integers(0, N, E)
    Ji, Jj = (rng.normal(size=(E, 6, 6)).astype(np.float32) for _ in range(2))
    A = rng.normal(size=(E, 6, 6)).astype(np.float32)
    info_w = (A @ A.transpose(0, 2, 1) + np.eye(6) * 10.0 ** rng.uniform(0, 4, (E, 1, 1)))
    info_w = info_w.astype(np.float32)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    damp6 = rng.uniform(1e-4, 1.0, (N, 6)).astype(np.float32)
    gj = JPG.make_graph(jnp.zeros((N, 3, 4)), jnp.asarray(ef, jnp.int32),
                        jnp.asarray(et, jnp.int32), jnp.zeros((E, 3, 4)))
    want = JPG._hx_product(gj, jnp.asarray(Ji), jnp.asarray(Jj), jnp.asarray(info_w),
                           jnp.asarray(x), jnp.asarray(damp6))
    idx2 = torch.from_numpy(np.stack([ef, et], 1).reshape(-1))
    plan2 = PG._sum_plan(idx2, torch.ones(2 * E, dtype=torch.bool), N)
    got = PG._hx_product(torch.cat([torch.from_numpy(Ji), torch.from_numpy(Jj)], -1),
                         torch.from_numpy(info_w), idx2, plan2,
                         torch.diag_embed(torch.from_numpy(damp6)), torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def _two_session_merge():
    """The 500-node two-session merge of tests/test_pose_graph.py: two
    parallel 250-node chains, the second initialized 5 m and 3 m off,
    odometry information alternating 1e8 and 1e2, closures every 25
    nodes (1e4), two 1e-6 edges."""
    n = 250
    gt = np.zeros((2 * n, 3, 4), np.float32)
    gt[:, :, :3] = np.eye(3)
    gt[:n, 0, 3] = gt[n:, 0, 3] = np.arange(n) * 0.1
    gt[n:, 1, 3] = 0.5
    init = gt.copy()
    init[n:, 0, 3] += 5.0
    init[n:, 1, 3] += 3.0
    rel = np.eye(3, 4, dtype=np.float32)
    rel[0, 3] = 0.1
    ef, et, meas, info = [], [], [], []
    for s in range(2):
        for i in range(n - 1):
            ef.append(s * n + i)
            et.append(s * n + i + 1)
            meas.append(rel)
            info.append(np.eye(6, dtype=np.float32) * (1e8 if i % 7 == 0 else 1e2))
    close = np.eye(3, 4, dtype=np.float32)
    close[1, 3] = 0.5
    for i in range(0, n, 25):
        ef.append(i)
        et.append(n + i)
        meas.append(close)
        info.append(np.eye(6, dtype=np.float32) * 1e4)
    for i in (3, 150):
        ef.append(i)
        et.append(i + 1)
        meas.append(rel)
        info.append(np.eye(6, dtype=np.float32) * 1e-6)
    return init, np.array(ef), np.array(et), np.stack(meas), np.stack(info)


def test_two_session_merge_through_optimize_matches_jax():
    """500 nodes, past the 400-node dense threshold: ``optimize`` runs PCG
    with 500 CG iterations on both sides."""
    init, ef, et, meas, info = _two_session_merge()
    gj = JPG.make_graph(jnp.asarray(init), jnp.asarray(ef, jnp.int32), jnp.asarray(et, jnp.int32),
                        jnp.asarray(meas), jnp.asarray(info))
    oj, cj = JPG.optimize(gj, iters=24)
    ot, ct = PG.optimize(PG.make_graph(torch.from_numpy(init), ef, et, meas, info), iters=24)
    pj, pt = np.asarray(oj.poses), ot.poses.numpy()
    assert np.isfinite(pt).all() and np.isfinite(float(ct))
    dy = pt[250:, 1, 3] - pt[:250, 1, 3]
    closure_nodes = np.arange(0, 250, 25)
    assert np.all(np.abs(dy[closure_nodes] - 0.5) < 0.05), dy[closure_nodes]
    assert np.all(np.abs(dy - 0.5) < 0.15), (dy.min(), dy.max())
    assert abs(float(ct) - float(cj)) <= 0.1 * float(cj)
    dyj = pj[250:, 1, 3] - pj[:250, 1, 3]
    np.testing.assert_allclose(dy[closure_nodes], dyj[closure_nodes], atol=0.01)


def test_optimize_poses_dict_matches_jax():
    """The tool-side solve over dicts: a ring with a landmark link (its
    node placed from the link) and a disconnected node left unchanged."""
    from rtabmap_tpu.memory.memory import Link as JLink
    from rtabmap_tpu_torch.memory.memory import LINK_GLOBAL_CLOSURE, LINK_LANDMARK, Link

    init, ef, et, meas, info, _ = _ring()
    poses = {i + 1: init[i] for i in range(len(init))}
    poses[99] = np.eye(3, 4, dtype=np.float32)
    lm = np.eye(3, 4, dtype=np.float32)
    lm[:3, 3] = [0.5, 0.2, 1.0]
    links = [(int(f) + 1, int(t) + 1, LINK_GLOBAL_CLOSURE, m, i)
             for f, t, m, i in zip(ef, et, meas, info)]
    links += [(3, -7, LINK_LANDMARK, lm, np.eye(6, dtype=np.float32) * 50),
              (9, -7, LINK_LANDMARK, T_compose_inv(init[8], init[2], lm),
               np.eye(6, dtype=np.float32) * 50)]
    want = JPG.optimize_poses_dict(poses, [JLink(*lk) for lk in links], root_id=1)
    got = PG.optimize_poses_dict(poses, [Link(*lk) for lk in links], root_id=1, device="cpu")
    assert sorted(got) == sorted(want)
    assert -7 in got and np.array_equal(got[99], poses[99])
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-3, err_msg=str(k))


def T_compose_inv(a, b, t):
    """inv(a) * b * t for (3,4) poses: a landmark seen from node b's link
    ``t``, as seen from node a."""
    return _mul(_mul(_inv(a), b), t).astype(np.float32)

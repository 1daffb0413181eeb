"""Dense pose-graph optimization: the port (device="cpu") against the JAX
package on a noisy planar ring with loop closures and one wrong closure.

Tolerances and why: residual Jacobians within 1e-5 (the port's closed
form against the JAX twin's forward-mode autodiff of the same float32
SE(3) residual; in float64 the closed form equals PyTorch's own autodiff
of the port's residual to 1e-8, the series cut of its coefficients); optimized poses within 1e-3 and the final chi2 within 1e-3
relative (20 LM iterations of a float32 Cholesky of a 144 x 144 system
whose diagonal spans 1 .. 1e8 amplify ulp differences).
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


def test_optimize_past_the_dense_threshold_is_later_work():
    init, ef, et, meas, info, _ = _ring()
    g = PG.make_graph(torch.from_numpy(init), ef, et, meas, info)
    with pytest.raises(NotImplementedError, match="optimize_pcg"):
        PG.optimize(g, dense_threshold=10)


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 0.3, 1.5])
def test_closed_form_jacobians_equal_autodiff(scale):
    """The closed-form edge and prior Jacobians against forward-mode
    autodiff of the port's own residuals, in float64, from residuals near
    zero (the solver's regime) to 1.5 rad."""
    from torch.func import jacfwd, vmap

    from rtabmap_tpu_torch.geometry import transform as T

    gen = torch.Generator().manual_seed(int(scale * 1e4))
    rnd = lambda n: torch.randn(n, 6, dtype=torch.float64, generator=gen)  # noqa: E731
    pi, pj = T.se3_exp(rnd(64)), T.se3_exp(rnd(64))
    meas = T.compose(T.relative(pi, pj), T.se3_exp(scale * rnd(64)))
    z = torch.zeros(6, dtype=torch.float64)

    def edge(a, b, P, Q, M):
        return PG._edge_residual(T.retract(P, a), T.retract(Q, b), M)

    def prior(a, P, M):
        return T.se3_log(T.compose(T.inverse(M), T.retract(P, a)))

    _, Ji, Jj = PG._edge_residual_jac(pi, pj, meas)
    for k, J in ((0, Ji), (1, Jj)):
        ref = vmap(lambda P, Q, M: jacfwd(edge, argnums=k)(z, z, P, Q, M))(pi, pj, meas)
        np.testing.assert_allclose(J.numpy(), ref.numpy(), atol=1e-8)
    _, Jp = PG._prior_residual_jac(pi, meas)
    ref = vmap(lambda P, M: jacfwd(prior)(z, P, M))(pi, meas)
    np.testing.assert_allclose(Jp.numpy(), ref.numpy(), atol=1e-8)

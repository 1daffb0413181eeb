"""The pose graph's closed-form edge and prior Jacobians against
forward-mode autodiff of the same residuals, at rotation scales from
1e-4 to 1.5 rad.

Tolerances as tests/test_torch_pose_graph.py states them (in float64 the
closed form equals PyTorch's autodiff to 1e-8, the series cut of its
coefficients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.optim import pose_graph as JPG
from rtabmap_tpu_torch.optim import pose_graph as PG
from torch_port_threads import one_torch_thread  # noqa: F401


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

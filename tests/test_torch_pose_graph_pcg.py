"""The matrix-free pose-graph solve (PCG) on the noisy planar ring of
tests/test_torch_pose_graph.py: the port (device="cpu") against the JAX
package, plain, with the Huber and DCS kernels and with xyz-only priors.

Tolerances as tests/test_torch_pose_graph.py states them: poses within
1e-4 and chi2 within 1e-4 relative (80 CG iterations of float32 sums in
another order; measured 1.5e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.optim import pose_graph as JPG
from rtabmap_tpu_torch.optim import pose_graph as PG
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_pose_graph import _priors, _ring  # noqa: F401


@pytest.mark.parametrize("mode", ["plain", "huber", "dcs", "priors"])
def test_optimize_pcg_matches_jax(mode):
    """'huber': the Huber kernel on every edge; 'dcs': the closures
    switchable with the annealed phi; 'priors': unary xyz priors."""
    init, ef, et, meas, info, switch = _ring()
    pj = pt = {}
    if mode == "priors":
        idx, pm, pi = _priors(init)
        pj = dict(priors_idx=jnp.asarray(idx, jnp.int32), priors_meas=jnp.asarray(pm),
                  priors_info=jnp.asarray(pi))
        pt = dict(priors_idx=idx, priors_meas=pm, priors_info=pi)
    gj = JPG.make_graph(jnp.asarray(init), jnp.asarray(ef, jnp.int32), jnp.asarray(et, jnp.int32),
                        jnp.asarray(meas), jnp.asarray(info), **pj)
    gt = PG.make_graph(torch.from_numpy(init), ef, et, meas, info, **pt)
    kw = {"robust": mode == "huber", "iters": 15, "cg_iters": 80}
    oj, cj = JPG.optimize_pcg(gj, switch_mask=jnp.asarray(switch) if mode == "dcs" else None,
                              **kw)
    ot, ct = PG.optimize_pcg(gt, switch_mask=torch.from_numpy(switch) if mode == "dcs" else None,
                             **kw)
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses), atol=1e-4)
    assert abs(float(ct) - float(cj)) <= 1e-4 * abs(float(cj))
    assert float(ct) < 0.5 * float(PG.graph_chi2(gt))

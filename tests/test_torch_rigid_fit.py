"""The weighted Kabsch fit ``ransac.rigid_from_correspondences`` against
the JAX twin on seeded cases (general, planar, three-point, zero-angle,
...), with tests/test_torch_geometry_linalg.py's tolerances (1e-6 on
rotations and poses; the rank-2 completion held exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.ops import linalg as JL
from rtabmap_tpu.ops.ransac import rigid_from_correspondences as j_rigid
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import linalg as L
from rtabmap_tpu_torch.ops.ransac import rigid_from_correspondences
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_geometry_linalg import _close, _t  # noqa: F401


@pytest.mark.parametrize("case", ["general", "planar", "three-point", "zero-angle",
                                  "tiny-angle", "near-pi"])
def test_rigid_from_correspondences(case):
    rng = np.random.default_rng(["general", "planar", "three-point", "zero-angle",
                                 "tiny-angle", "near-pi"].index(case) + 20)
    K = 3 if case == "three-point" else 60
    src = rng.normal(size=(K, 3)).astype(np.float32)
    if case in ("planar", "three-point"):
        src[:, 2] = 0.0
    angle = {"zero-angle": 0.0, "tiny-angle": 1e-8, "near-pi": np.pi - 1e-6}.get(case, 0.7)
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    xi = np.concatenate([[0.2, -0.1, 0.4], axis * angle]).astype(np.float32)
    P = np.asarray(JT.se3_exp(jnp.asarray(xi)))
    dst = (src @ P[:, :3].T + P[:, 3]).astype(np.float32)
    w = rng.uniform(0.5, 1.0, K).astype(np.float32)
    if K > 3:
        w[:5] = 0.0
    Rt = rigid_from_correspondences(_t(src), _t(dst), _t(w))
    Rj = j_rigid(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    _close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(Rt.numpy(), P, atol=1e-4)

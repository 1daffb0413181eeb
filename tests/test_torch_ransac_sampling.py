"""The contract of the RANSAC's drawn samples (``ransac._sample_indices``
on a CPU ``torch.Generator``): valid slots only, the shape, and the
generator's determinism. The samples themselves differ from the JAX
twin's by design; tests/test_torch_ransac.py injects the twin's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.ops import ransac as JR
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import ransac as R
from torch_port_threads import one_torch_thread  # noqa: F401


def test_sample_indices_contract():
    valid = torch.from_numpy(np.random.default_rng(0).random((2, 50)) > 0.6)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = R._sample_indices(g1, valid, 64, 6)
    assert a.shape == (2, 64, 6)
    assert bool(torch.gather(valid, 1, a.reshape(2, -1)).all())
    assert torch.equal(a, R._sample_indices(g2, valid, 64, 6))
    # no valid slot: index 0 (a zero-inlier hypothesis), as the JAX twin
    none = R._sample_indices(g1, torch.zeros(1, 10, dtype=torch.bool), 4, 3)
    assert int(none.max()) == 0

"""The elevation map against the JAX twin on the clouds of
tests/test_torch_grids.py, with its tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.maps import grids as JG
from rtabmap_tpu.maps import voxel as JV
from rtabmap_tpu.ops import cloud as JCL
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.maps import grids as G
from rtabmap_tpu_torch.maps import voxel as V
from torch_port_threads import one_torch_thread  # noqa: F401


def test_elevation_map():
    jm = JV.ElevationMap(cell_size=0.2, size_m=10.0)
    tm = V.ElevationMap(cell_size=0.2, size_m=10.0, device="cpu")
    rng = np.random.default_rng(8)
    for nid in range(1, 4):
        pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-3, 3, 400),
                        rng.uniform(-1, 2, 400)], 1).astype(np.float32)
        valid = rng.random(400) > 0.1
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, 3] = [0.5 * nid, -0.2, 0.1]
        jm.update(nid, pose, pts, valid)
        tm.update(nid, pose, pts, valid)
    jm.update(2, np.eye(3, 4, dtype=np.float32), *jm.cache[2])   # a move re-assembles
    tm.update(2, np.eye(3, 4, dtype=np.float32), *tm.cache[2])
    for a, b in zip(tm.arrays(), jm.arrays()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert tm.arrays()[2].sum() > 100

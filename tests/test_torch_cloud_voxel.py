"""The voxel filter's keep mask against the JAX twin's on a 16-ring
VLP-16 scan, exactly, at three voxel sizes (tests/test_torch_cloud.py's
scan and tolerances).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.ops import cloud as JCL
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import cloud as CL
from rtabmap_tpu_torch.tools import lidar_mapping as LM
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_cloud import _scan  # noqa: F401


@pytest.mark.parametrize("voxel", [0.05, 0.08, 0.3])
def test_voxel_filter_mask_exact(voxel):
    pts, valid = _scan(180, 6)
    valid[::7] = False
    mj = np.asarray(JCL.voxel_filter(jnp.asarray(pts), jnp.asarray(valid), voxel))
    mt = CL.voxel_filter(torch.from_numpy(pts), torch.from_numpy(valid), voxel).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert 0 < mt.sum() < valid.sum()

"""Point-to-plane ICP and ``register_scans`` (the LiDAR path's users of
K2's plain version on the CPU) against the JAX twins, with the scans and
tolerances of tests/test_torch_nn3d_icp.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.ops import cloud as JCL
from rtabmap_tpu.ops import icp as JICP
from rtabmap_tpu.ops.pallas.nn3d import pallas_nn3d
from rtabmap_tpu_torch.ops import icp as ICP
from rtabmap_tpu_torch.ops.cuda import compact_cases as CC
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_nn3d_icp import _close, _search_then_mask, scan_pair  # noqa: F401


@pytest.mark.parametrize("point_to_plane", [False, True], ids=["p2p", "p2plane"])
def test_icp_matches_jax(scan_pair, point_to_plane):
    (src, vs, dst, vd), guess, true_rel = scan_pair
    nrm = None
    if point_to_plane:
        nrm = np.array(JCL.estimate_normals(jnp.asarray(dst), jnp.asarray(vd), k=8)[0])
    rj = JICP.icp(jnp.asarray(src), jnp.asarray(vs), jnp.asarray(dst), jnp.asarray(vd),
                  guess=jnp.asarray(guess), iters=15, point_to_plane=point_to_plane,
                  dst_normals=None if nrm is None else jnp.asarray(nrm))
    rt = ICP.icp(torch.from_numpy(src), torch.from_numpy(vs), torch.from_numpy(dst),
                 torch.from_numpy(vd), guess=torch.from_numpy(guess), iters=15,
                 point_to_plane=point_to_plane,
                 dst_normals=None if nrm is None else torch.from_numpy(nrm))
    _close(rt, rj)
    if point_to_plane:   # and it did align the scans
        assert np.abs(rt.transform.numpy()[:, 3] - true_rel[:, 3]).max() < 0.02


@pytest.mark.parametrize("case", ["p2p", "p2plane", "register"])
def test_icp_query_mask_same_bits(scan_pair, monkeypatch, case):
    (src, vs, dst, vd), guess, _ = scan_pair
    vs = vs & (np.random.default_rng(3).random(len(vs)) >= 0.2)
    args = [torch.from_numpy(a) for a in (src, vs, dst, vd)]

    def run():
        if case == "register":
            return ICP.register_scans(*args, guess=torch.from_numpy(guess), iters=8)
        nrm = None
        if case == "p2plane":
            nrm = torch.from_numpy(np.array(JCL.estimate_normals(
                jnp.asarray(dst), jnp.asarray(vd), k=8)[0]))
        return ICP.icp(*args, guess=torch.from_numpy(guess), iters=8,
                       point_to_plane=nrm is not None, dst_normals=nrm), None

    (masked, cov_m) = run()
    monkeypatch.setattr(ICP, "nn3d_search", _search_then_mask)
    (unmasked, cov_u) = run()
    for a, b in zip(masked[:4], unmasked[:4]):
        assert torch.equal(a, b)
    if cov_m is not None:
        assert torch.equal(cov_m, cov_u)


def test_register_scans_matches_jax(scan_pair):
    (src, vs, dst, vd), guess, _ = scan_pair
    rj, cj = JICP.register_scans(jnp.asarray(src), jnp.asarray(vs), jnp.asarray(dst),
                                 jnp.asarray(vd), guess=jnp.asarray(guess), voxel=0.05,
                                 iters=15)
    rt, ct = ICP.register_scans(torch.from_numpy(src), torch.from_numpy(vs),
                                torch.from_numpy(dst), torch.from_numpy(vd),
                                guess=torch.from_numpy(guess), voxel=0.05, iters=15)
    _close(rt, rj, ct, cj)

"""3-D nearest neighbour (K2) and ICP: the port (device="cpu", so K2's plain
version) against the JAX package on the CPU. The kernel itself is held
against the plain version on the card in tests/test_torch_cuda_kernels.py.

Tolerances and why:
- K2 against ``pallas_nn3d(..., interpret=True)``: indices equal; distances
  within 1e-6 relative. Both take direct differences in the same order,
  but XLA on the CPU may reassociate or contract the sum (one ulp, 3e-8,
  measured on these cases).
- K2 with a query mask: the same on the valid queries; exactly (+inf, 0)
  on the masked ones.
- ICP with K2's query mask against the search the callers made before it
  (every query searched, the mask applied afterwards): equal bits, since
  a masked row reads +inf and carries zero weight either way.
- ICP: transforms, correspondence ratio and RMSE within 1e-4, on 90 x 16
  scans. The JAX CPU search uses the expanded form |s|^2 - 2 s.d + |d|^2
  (distances off by up to 2e-6), the port the direct form, and the
  iterations sum in another order.
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
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from torch_port_threads import one_torch_thread  # noqa: F401


def _nn_case(name):
    rng = np.random.default_rng(["invalid", "empty", "ties"].index(name))
    if name == "empty":
        Q, N = 128, 512
        valid = np.zeros(N, bool)
    else:
        Q, N = 512, 2048
        valid = np.ones(N, bool)
        valid[100:500] = False
    src = rng.normal(size=(Q, 3)).astype(np.float32)
    dst = rng.normal(size=(N, 3)).astype(np.float32)
    if name == "ties":
        # duplicated points across blocks and queries sitting on points:
        # exact ties, which both sides give to the lowest index
        dst[1500:1700] = dst[600:800]
        src[:100] = dst[rng.integers(600, 800, 100)]
    return src, dst, valid


@pytest.mark.parametrize("name", ["invalid", "empty", "ties"])
def test_nn3d_plain_matches_pallas_interpret(name):
    src, dst, valid = _nn_case(name)
    d, i = K2.nn3d(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid))
    blocks = dict(qblock=128, dblock=512) if name == "empty" else {}
    dp, ip = pallas_nn3d(jnp.asarray(src.T), jnp.asarray(dst.T), jnp.asarray(valid),
                         interpret=True, **blocks)
    dp, ip = np.asarray(dp), np.asarray(ip)
    np.testing.assert_array_equal(i.numpy(), ip)
    if name == "empty":
        assert np.all(np.isinf(d.numpy())) and np.all(i.numpy() == 0)
    else:
        np.testing.assert_allclose(d.numpy(), dp, rtol=1e-6, atol=0)
    if name == "ties":
        assert np.all(i.numpy()[:100] < 1500)


def test_nn3d_plain_contract_and_checks():
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.normal(size=(37, 3)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(5000) > 0.3)
    d, i = K2.nn3d(src, dst, valid)
    diff = src[:, None, :] - dst[None]
    full = ((diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2)
    full = torch.where(valid, full, float("inf"))
    assert torch.equal(d, full.min(1).values)
    assert torch.equal(i.long(), full.argmin(1))
    # CPU tensors never launch the kernels
    assert K2.nn3d_search.launches == 0 and K2.nn3d_prepare.launches == 0
    with pytest.raises(ValueError):
        K2.nn3d(src.double(), dst, valid)
    with pytest.raises(ValueError):
        K2.nn3d(src, dst[:, :2], valid)
    with pytest.raises(ValueError):
        K2.nn3d(src, dst, valid[:10])


@pytest.mark.parametrize("name", ["invalid", "ties", "all-masked", "no-valid-point"])
def test_nn3d_plain_query_mask(name):
    src, dst, valid = _nn_case("empty" if name == "no-valid-point" else
                               "invalid" if name == "all-masked" else name)
    rng = np.random.default_rng(7)
    src_valid = np.zeros(len(src), bool) if name == "all-masked" else rng.random(len(src)) >= 0.3
    d, i = K2.nn3d(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                   torch.from_numpy(src_valid))
    d, i = d.numpy(), i.numpy()
    assert np.all(np.isinf(d[~src_valid])) and np.all(i[~src_valid] == 0)
    blocks = dict(qblock=128, dblock=512) if name == "no-valid-point" else {}
    dp, ip = pallas_nn3d(jnp.asarray(src.T), jnp.asarray(dst.T), jnp.asarray(valid),
                         interpret=True, **blocks)
    dp, ip = np.asarray(dp)[src_valid], np.asarray(ip)[src_valid]
    np.testing.assert_array_equal(i[src_valid], ip)
    if name == "no-valid-point":
        assert np.all(np.isinf(d)) and np.all(i == 0)
    else:
        np.testing.assert_allclose(d[src_valid], dp, rtol=1e-6, atol=0)


def _scan_pair():
    # 16 rings: 8-neighbourhoods span rings, so every normal is well defined
    # (see tests/test_torch_cloud.py for the 6-ring scans, where 1.7% are not)
    poses = np.asarray(JS.lidar_trajectory(25, radius=2.0))
    a, b = poses[3], poses[4]
    dst, vd = JS.lidar_scan(jnp.asarray(a), n_azimuth=90, n_rings=16)
    src, vs = JS.lidar_scan(jnp.asarray(b), n_azimuth=90, n_rings=16)
    true_rel = np.asarray(JT.relative(jnp.asarray(a), jnp.asarray(b)))
    guess = np.array(JT.compose(jnp.asarray(true_rel),
                                  JT.se3_exp(jnp.asarray([0.03, -0.02, 0.0, 0.0, 0.0, 0.02]))))
    return [np.array(x) for x in (src, vs, dst, vd)], guess, true_rel


@pytest.fixture(scope="module")
def scan_pair():
    return _scan_pair()


def _close(res_t, res_j, cov_t=None, cov_j=None):
    np.testing.assert_allclose(res_t.transform.numpy(), np.asarray(res_j.transform), atol=1e-4)
    assert abs(float(res_t.correspondence_ratio) - float(res_j.correspondence_ratio)) <= 1e-4
    assert abs(float(res_t.fitness_rmse) - float(res_j.fitness_rmse)) <= 1e-4
    assert bool(res_t.valid) == bool(res_j.valid)
    if cov_t is not None:
        np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-3, atol=1e-7)


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


def _search_then_mask(moved, plan):
    """The search as the callers made it before K2 took a query mask:
    every query searched, the mask applied to the distances afterwards."""
    d, i = K2.nn3d_reference(moved, plan.dst, plan.dst_valid)
    return torch.where(plan.src_valid, d, float("inf")), i


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

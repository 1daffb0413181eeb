"""Point-cloud utilities: the port against the JAX package on the CPU.

Tolerances and why:
- ``voxel_filter``: the mask exactly (the same float32 division and floor;
  the port's int64 hash keeps the same low 16 bits as JAX's wrapping int32).
- ``estimate_normals``: |dot| >= 1 - 1e-5 and the orientation exact where
  the normal is defined: the gap between the two smallest covariance
  eigenvalues is at least 1e-3 of the trace. Below that the analytic eigen
  solver (an arccos near 1, about 1e-4 of the trace lost in float32) picks
  an arbitrary direction in the plane of the two eigenvectors, on both
  sides alike. On the 6-ring 180-azimuth scans of the JAX package's tests
  30% of the neighbourhoods fall below that gap, lying along one ring,
  nearly on a line, and 1.7% of the normals differ grossly between the
  two implementations (measured); on a 16-ring 90-azimuth scan almost none.
  Curvature (lambda_min / trace, which the path discards) within 5e-5
  there: the same arccos loses up to 2.9e-5 of it (measured). Duplicated points tie exactly in the k-NN;
  copies give the same covariance, so the tie order does not show.
- organized clouds and filters: 1e-6 absolute, masks exactly.
- the LiDAR simulator: validity exactly, points within 5e-5 m (the port
  takes its azimuths from another float32 formula and sin/cos from other
  libraries: measured 1.2e-5 m at 4 m range); the sensor-frame noise is
  the seeded numpy draw, within float32 rounding of the sum.
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


def _scan(n_azimuth=90, n_rings=16, pose_index=3):
    pose = JS.lidar_trajectory(25, radius=2.0)[pose_index]
    pts, valid = JS.lidar_scan(pose, n_azimuth=n_azimuth, n_rings=n_rings)
    return np.array(pts), np.array(valid)


def _defined(pts, valid, k=8):
    """Points whose k-NN covariance has two smallest eigenvalues at least
    1e-3 of its trace apart (float64, the neighbours of the JAX twin)."""
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    d2[~valid] = np.inf
    d2[:, ~valid] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    X = pts[idx].astype(np.float64)
    X = X - X.mean(1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", X, X) / k)
    return valid & (lam[:, 1] - lam[:, 0] >= 1e-3 * lam.sum(-1))


@pytest.mark.parametrize("case", ["scan", "ring-scan", "duplicates"])
def test_estimate_normals(case):
    pts, valid = _scan(180, 6) if case == "ring-scan" else _scan()
    valid = np.array(JCL.voxel_filter(jnp.asarray(pts), jnp.asarray(valid), 0.05))
    if case == "duplicates":   # copies of every 10th valid point, appended
        dup = np.nonzero(valid)[0][::10]
        pts = np.concatenate([pts, pts[dup]])
        valid = np.concatenate([valid, np.ones(len(dup), bool)])
    view = np.array([0.1, -0.2, 0.3], np.float32)
    nj, cj = JCL.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=8,
                                  viewpoint=jnp.asarray(view))
    nt, ct = CL.estimate_normals(torch.from_numpy(pts), torch.from_numpy(valid), k=8,
                                 viewpoint=torch.from_numpy(view))
    nj, nt = np.asarray(nj), nt.numpy()
    defined = _defined(pts, valid)
    assert defined.sum() >= (0.6 if case == "ring-scan" else 0.97) * valid.sum()
    dot = (nj * nt).sum(-1)[defined]
    assert dot.min() >= 1 - 1e-5          # same direction and same orientation
    np.testing.assert_array_equal(nt[~valid], 0.0)
    np.testing.assert_allclose(ct.numpy()[defined], np.asarray(cj)[defined], atol=5e-5)


def test_organized_clouds_and_filters():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 4.0, (24, 32)).astype(np.float32)
    depth[3:6, 4:9] = 0.0
    jc = JC.CameraModel.make(40.0, 42.0, 15.5, 11.5, 32, 24)
    tc = C.CameraModel.make(40.0, 42.0, 15.5, 11.5, 32, 24)
    pj, oj = JCL.cloud_from_depth(jnp.asarray(depth), jc, decimation=2, max_depth=3.5)
    pt, ot = CL.cloud_from_depth(torch.from_numpy(depth), tc, decimation=2, max_depth=3.5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    nj, _ = JCL.normals_from_depth(jnp.asarray(depth), jc)
    nt, _ = CL.normals_from_depth(torch.from_numpy(depth), tc)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)

    pts = rng.normal(0, 2, (500, 3)).astype(np.float32)
    valid = rng.random(500) > 0.1
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    np.testing.assert_array_equal(
        CL.range_filter(tp, tv, 0.5, 3.0).numpy(),
        np.asarray(JCL.range_filter(jnp.asarray(pts), jnp.asarray(valid), 0.5, 3.0)))
    np.testing.assert_array_equal(
        CL.crop_box(tp, tv, [-1, -2, -1], [2, 1, 1]).numpy(),
        np.asarray(JCL.crop_box(jnp.asarray(pts), jnp.asarray(valid), [-1, -2, -1], [2, 1, 1])))
    Tab = np.eye(3, 4, dtype=np.float32)
    Tab[:, 3] = [0.5, -1.0, 2.0]
    np.testing.assert_allclose(
        CL.transform_cloud(torch.from_numpy(Tab), tp).numpy(),
        np.asarray(JCL.transform_cloud(jnp.asarray(Tab), jnp.asarray(pts))), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    kept = CL.random_subsample(tp, tv, 100, gen).numpy()
    assert kept.sum() == 100 and not (kept & ~valid).any()


def test_lidar_simulator_matches_jax():
    np.testing.assert_allclose(S.lidar_trajectory(40), np.asarray(JS.lidar_trajectory(40)),
                               atol=1e-7)
    pose = S.lidar_trajectory(40)[7]
    for kw in (dict(n_azimuth=180, n_rings=6), dict(n_azimuth=225, n_rings=16,
                                                   elev_span=S.VLP16_ELEV_SPAN)):
        pt, vt = S.lidar_scan(pose, device="cpu", **kw)
        pj, vj = JS.lidar_scan(jnp.asarray(pose), **kw)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-5)
    gt, scans = LM.sensor_sequence(3, n_azimuth=20, n_rings=4, noise=0.01, device="cpu")
    rng = np.random.default_rng(0)
    for pose, (pts, valid) in zip(gt, scans):
        clean, _ = S.lidar_scan(pose, n_azimuth=20, n_rings=4, elev_span=S.VLP16_ELEV_SPAN,
                                device="cpu")
        np.testing.assert_allclose((pts - clean).numpy(), S.sensor_noise(rng, 80, 0.01), atol=1e-6)


def _dense_normals(pts, valid, k=8):
    """The port's estimate_normals before it compacted the valid rows: the
    blocked k-NN over all N rows, invalid ones included."""
    n = pts.shape[0]
    d2 = ((pts[:, None, :] - pts[None]) ** 2)
    d2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
    d2 = torch.where(valid[None, :] & valid[:, None], d2, float("inf"))
    idx = torch.topk(d2, k, dim=1, largest=False).indices
    nbrs = pts[idx]
    X = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", X, X) / k
    from rtabmap_tpu_torch.ops import linalg as L3

    lam, normal = L3.eigvec_min_sym3(cov)
    flip = (normal * (-pts)).sum(-1) < 0
    normal = torch.where(flip[:, None], -normal, normal)
    curv = lam / torch.clamp_min(cov.diagonal(dim1=-2, dim2=-1).sum(-1), 1e-12)
    return torch.where(valid[:, None], normal, torch.zeros_like(normal)), curv, n


def test_estimate_normals_mostly_invalid_slab():
    """A slab padded past twice its points, as the engine's assembled scan
    maps are: the compacted search gives the dense search's normals and
    curvatures on the valid rows bit for bit (the same distances, the same
    k smallest), zero normals on the invalid rows, and there the JAX
    twin's curvature (its top_k gives a row without valid pairs the
    neighbours 0..k-1)."""
    pts, valid = _scan()
    valid = np.array(JCL.voxel_filter(jnp.asarray(pts), jnp.asarray(valid), 0.05))
    pad = 3 * pts.shape[0]
    pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    assert valid.mean() < 0.5
    nt, ct = CL.estimate_normals(torch.from_numpy(pts), torch.from_numpy(valid), k=8)
    nd, cd, _ = _dense_normals(torch.from_numpy(pts), torch.from_numpy(valid))
    assert torch.equal(nt[torch.from_numpy(valid)], nd[torch.from_numpy(valid)])
    assert torch.equal(ct[torch.from_numpy(valid)], cd[torch.from_numpy(valid)])
    np.testing.assert_array_equal(nt.numpy()[~valid], 0.0)
    _, cj = JCL.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=8)
    np.testing.assert_allclose(ct.numpy()[~valid], np.asarray(cj)[~valid], atol=5e-5)

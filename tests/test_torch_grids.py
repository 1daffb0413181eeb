"""Occupancy grids and the elevation map: the port's maps/grids.py and
maps/voxel.ElevationMap against their JAX twins on the same numpy inputs
(a 16-ring LiDAR scan of the default room, normals from the JAX package).

Tolerances and why: cell masks, occupancy maps (int8) and removed-cell
counts exactly (integer outputs); cell coordinates within 1e-6 m (the
same float32 floor of the same division); log-odds within 1e-5 (equal
deltas scatter-added in another order can differ in the last bit);
heights within 1e-5 m and counts exactly; cloud-map points within 1e-5 m
(a float32 rigid transform summed in another order)."""
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


def _cloud(i=3, n_azimuth=90):
    pose = JS.lidar_trajectory(25, radius=2.0)[i]
    pts, valid = JS.lidar_scan(pose, n_azimuth=n_azimuth, n_rings=16)
    pts, valid = np.array(pts), np.array(valid)
    # a floor patch under the sensor, so that some cells are ground
    rng = np.random.default_rng(i)
    floor = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-2, 2, 200),
                      rng.uniform(-0.05, 0.05, 200)], 1).astype(np.float32)
    pts = np.concatenate([pts, floor])
    valid = np.concatenate([valid, np.ones(200, bool)])
    valid[::11] = False
    nrm, _ = JCL.estimate_normals(jnp.asarray(pts), jnp.asarray(valid), k=8)
    return pts, valid, np.asarray(nrm), np.asarray(pose)


def _grid_equal(t: G.LocalGrid, j, atol=1e-6):
    for name in ("ground", "obstacles", "empty"):
        tv, jv = getattr(t, name + "_valid").numpy(), np.asarray(getattr(j, name + "_valid"))
        np.testing.assert_array_equal(tv, jv, err_msg=name)
        np.testing.assert_allclose(getattr(t, name).numpy()[tv], np.asarray(getattr(j, name))[jv],
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("max_points", [256, 1024])
def test_local_grid_from_cloud(max_points):
    pts, valid, nrm, _ = _cloud()
    j = JG.local_grid_from_cloud(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(nrm),
                                 max_points=max_points, ray_steps=16)
    t = G.local_grid_from_cloud(torch.from_numpy(pts), torch.from_numpy(valid),
                                torch.from_numpy(nrm), max_points=max_points, ray_steps=16)
    _grid_equal(t, j)
    assert int(t.ground_valid.sum()) > 0 and int(t.obstacles_valid.sum()) > 0


def test_local_grid_from_depth():
    rng = np.random.default_rng(2)
    depth = rng.uniform(1.0, 4.0, (48, 64)).astype(np.float32)
    depth[:8] = 0.0
    jc = JC.CameraModel.make(50.0, 50.0, 31.5, 23.5, 64, 48)
    tc = C.CameraModel.make(50.0, 50.0, 31.5, 23.5, 64, 48)
    j = JG.local_grid_from_depth(jnp.asarray(depth), jc, decimation=2, max_points=256,
                                 ray_steps=8)
    t = G.local_grid_from_depth(torch.from_numpy(depth), tc, decimation=2, max_points=256,
                                ray_steps=8)
    _grid_equal(t, j, atol=1e-5)


def _grids(n=4):
    out = {}
    for i in range(n):
        pts, valid, nrm, pose = _cloud(3 + 2 * i)
        j = JG.local_grid_from_cloud(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(nrm),
                                     max_points=512, ray_steps=16)
        out[i + 1] = (j, pose)
    return out


def test_occupancy_grid_update_assemble():
    grids = _grids()
    jo = JG.OccupancyGrid(cell_size=0.1, size_m=12.0)
    to = G.OccupancyGrid(cell_size=0.1, size_m=12.0, device="cpu")
    for nid, (g, pose) in grids.items():
        jo.update(nid, pose, g)
        to.update(nid, pose, G.LocalGrid(*(np.asarray(a) for a in g)))
    np.testing.assert_allclose(to.logodds.numpy(), np.asarray(jo.logodds), atol=1e-5)
    np.testing.assert_array_equal(to.to_occupancy(), jo.to_occupancy())
    # a node moves: update takes its old cells out; assemble rebuilds
    moved = {nid: p.copy() for nid, (_, p) in grids.items()}
    moved[2][:, 3] += np.float32(0.3)
    jo.update(2, moved[2], grids[2][0])
    to.update(2, moved[2], to.cache[2])
    np.testing.assert_allclose(to.logodds.numpy(), np.asarray(jo.logodds), atol=1e-5)
    jo.assemble(moved)
    to.assemble(moved)
    np.testing.assert_allclose(to.logodds.numpy(), np.asarray(jo.logodds), atol=1e-5)
    np.testing.assert_array_equal(to.to_occupancy(), jo.to_occupancy())
    np.testing.assert_allclose(to.probability().numpy(), np.asarray(jo.probability()),
                               atol=1e-6)
    assert (to.to_occupancy() == 100).sum() > 50


def test_cleanup_local_grids():
    grids = _grids(3)
    poses = {nid: p for nid, (_, p) in grids.items()}
    jg = {nid: g for nid, (g, _) in grids.items()}
    # a transient obstacle seen by node 1 only, in a cell the others see free
    g1 = jg[1]
    ob = np.asarray(g1.obstacles).copy()
    ok = np.asarray(g1.obstacles_valid).copy()
    ob[0], ok[0] = np.asarray(g1.empty)[np.asarray(g1.empty_valid)][40], True
    jg[1] = g1._replace(obstacles=jnp.asarray(ob), obstacles_valid=jnp.asarray(ok))
    removed = []
    for radius, fg in ((0, False), (1, True)):
        jout, jn = JG.cleanup_local_grids(poses, jg, cell_size=0.1, size_m=12.0,
                                          radius=radius, filter_ground=fg)
        tout, tn = G.cleanup_local_grids(
            poses, {i: G.LocalGrid(*(np.asarray(a) for a in g)) for i, g in jg.items()},
            cell_size=0.1, size_m=12.0, radius=radius, filter_ground=fg, device="cpu")
        assert tn == jn
        removed.append(tn)
        for nid in jg:
            np.testing.assert_array_equal(tout[nid].obstacles_valid,
                                          np.asarray(jout[nid].obstacles_valid))
            np.testing.assert_array_equal(tout[nid].ground_valid,
                                          np.asarray(jout[nid].ground_valid))
    assert removed[0] > 0, removed


def test_cloud_map():
    rng = np.random.default_rng(7)
    jm, tm = JG.CloudMap(voxel=0.1), G.CloudMap(voxel=0.1)
    poses = {}
    for nid in range(1, 4):
        pts = rng.normal(size=(300, 3)).astype(np.float32)
        valid = rng.random(300) > 0.2
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, 3] = rng.normal(size=3)
        poses[nid] = pose
        jm.update(nid, pose, pts, valid)
        tm.update(nid, pose, torch.from_numpy(pts), torch.from_numpy(valid))
    cj, ct = jm.assemble(), tm.assemble()
    assert ct.shape == cj.shape
    np.testing.assert_allclose(ct, cj, atol=1e-5)
    np.testing.assert_allclose(tm.assemble({1: poses[1]}), jm.assemble({1: poses[1]}),
                               atol=1e-5)

"""TSDF fusion, surface nets, vertex colours and the mesh helpers: the
port (``rtabmap_tpu_torch/maps/tsdf.py``, ``maps/mesh.py``) against the JAX
twins on the same numpy inputs.

The scene: 48x36 renders (fx = fy = 40) of the default room from three
poses of ``loop_trajectory(24)``, fused into a 1.6 m cube at 8 cm voxels
around the part of the wall x = 4 m that they see.

Tolerances and why:
- ``_integrate``: tsdf and weight within 1e-5 on every voxel whose depth
  pixel is the same in both packages; the voxel centres' camera
  coordinates are float32 sums in another order, so a projection that lands
  within rounding of a pixel boundary may take the neighbouring pixel: at
  most 0.2% of the voxels, and the test counts them;
- ``surface_nets`` (given the same volume): vertices and faces exactly, in
  the same order (integer outputs; the vertices are float64 lattice
  arithmetic rounded once);
- ``color_vertices``: colours and the observed mask exactly (a gather at
  the same truncated pixel);
- ``organized_fast_mesh``: faces and masks exactly, points 1e-6;
  ``mesh_normals`` 1e-5 (``index_add_`` sums in another order);
- the PLY and OBJ files: written by one package, read by the other, equal
  to the printed precision (5 decimals).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.maps import mesh as JM
from rtabmap_tpu.maps import tsdf as JT
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.maps import mesh as M
from rtabmap_tpu_torch.maps import tsdf as TS
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = (40.0, 40.0, 23.5, 17.5, 48, 36)
ORIGIN = (3.2, -0.8, -0.6)
SIZE = (1.6, 1.6, 1.6)
VOXEL = 0.08


@pytest.fixture(scope="module")
def scene():
    """The frames, rendered once by the port on the CPU (its renderer equals
    the twin's, tests/test_torch_engine_rgbd.py), and the twin's volume."""
    jcam = JC.CameraModel.make(*CAM)
    poses = S.loop_trajectory(24)[[0, 1, 2]]
    frames = [tuple(x.numpy() for x in S.render(p, C.CameraModel.make(*CAM), device="cpu"))
              for p in poses]
    jvol = JT.TSDFVolume(ORIGIN, SIZE, voxel=VOXEL)
    for p, (_, d) in zip(poses, frames):
        jvol.integrate(d, p, jcam)
    return poses, frames, jvol


def test_integrate_matches_the_twin(scene):
    poses, frames, jvol = scene
    vol = TS.TSDFVolume(ORIGIN, SIZE, voxel=VOXEL, device="cpu")
    assert vol.dims == jvol.dims and vol.trunc == jvol.trunc
    cam = C.CameraModel.make(*CAM)
    for p, (_, d) in zip(poses, frames):
        vol.integrate(d, p, cam)
    for port, twin in ((vol.tsdf, jvol.tsdf), (vol.weight, jvol.weight)):
        diff = np.abs(port.numpy() - np.asarray(twin))
        assert (diff > 1e-5).mean() <= 2e-3, (diff > 1e-5).sum()
    assert int((vol.weight > 0).sum()) > 500          # the volume saw surface


def test_surface_nets_equal_the_twin(scene):
    _, _, jvol = scene
    tsdf, weight = np.array(jvol.tsdf), np.array(jvol.weight)
    jv, jf = JT.surface_nets(tsdf, weight, np.asarray(ORIGIN, np.float32), VOXEL)
    v, f = TS.surface_nets(torch.from_numpy(tsdf), torch.from_numpy(weight),
                           np.asarray(ORIGIN, np.float32), VOXEL)
    assert len(jf) > 100
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(f.numpy(), jf)
    assert f.dtype == torch.int32
    # the same on a volume with sign flips everywhere (every quad orientation)
    rng = np.random.default_rng(3)
    noise = rng.uniform(-1, 1, (9, 8, 7)).astype(np.float32)
    w = (rng.uniform(size=noise.shape) > 0.1).astype(np.float32)
    jv, jf = JT.surface_nets(noise, w, (0.0, 0.0, 0.0), 0.1)
    v, f = TS.surface_nets(torch.from_numpy(noise), torch.from_numpy(w), (0.0, 0.0, 0.0), 0.1)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(f.numpy(), jf)
    # nothing to extract
    v, f = TS.surface_nets(torch.ones((4, 4, 4)), torch.ones((4, 4, 4)), (0, 0, 0), 0.1)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_color_vertices_match_the_twin(scene):
    poses, frames, jvol = scene
    jv, _ = jvol.extract_mesh()
    jcol, jseen = JT.color_vertices(jv, list(poses), [g for g, _ in frames],
                                    JC.CameraModel.make(*CAM))
    col, seen = TS.color_vertices(torch.from_numpy(jv), list(poses),
                                  [g for g, _ in frames], C.CameraModel.make(*CAM))
    np.testing.assert_array_equal(seen.numpy(), jseen)
    np.testing.assert_array_equal(col.numpy(), jcol)
    assert jseen.mean() > 0.5


def test_organized_mesh_normals_and_compaction(scene):
    _, frames, _ = scene
    depth = frames[0][1]
    jpts, jf, jok = JM.organized_fast_mesh(jnp.asarray(depth), JC.CameraModel.make(*CAM))
    pts, f, ok = M.organized_fast_mesh(torch.from_numpy(depth), C.CameraModel.make(*CAM))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.sum() > 100
    jn = JM.mesh_normals(jpts, jf, jok)
    n = M.mesh_normals(pts, f, ok)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5)
    cols = np.arange(len(depth.reshape(-1)) * 3).reshape(-1, 3) % 255
    for a, b in zip(M.compact_mesh(pts, f, ok, cols),
                    JM.compact_mesh(jpts, jf, jok, cols)):
        np.testing.assert_array_equal(a, b)


def test_mesh_files_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (60, 3)).astype(np.int32)
    c = rng.integers(0, 255, (40, 3)).astype(np.uint8)
    n = rng.normal(size=(40, 3)).astype(np.float32)
    for write, read in ((M.write_ply, JM.read_ply), (JM.write_ply, M.read_ply)):
        p = str(tmp_path / "m.ply")
        write(p, torch.from_numpy(v) if write is M.write_ply else v, faces=f, colors=c,
              normals=n)
        rv, rf, rc = read(p)
        np.testing.assert_allclose(rv, v, atol=5e-6)
        np.testing.assert_array_equal(rf, f)
        np.testing.assert_array_equal(rc, c)
        assert M.read_ply_counts(p) == JM.read_ply_counts(p) == (40, 60)
    M.write_ply(str(tmp_path / "a.ply"), v, faces=f)
    JM.write_ply(str(tmp_path / "b.ply"), v, faces=f)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    M.write_obj(str(tmp_path / "a.obj"), v, f)
    JM.write_obj(str(tmp_path / "b.obj"), v, f)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()


def test_gain_compensation_matches_the_twin():
    ov = [(0, 1, 0.5, 0.55), (1, 2, 0.6, 0.4), (0, 2, 0.3, 0.33)]
    np.testing.assert_array_equal(M.gain_compensation(ov, 3), JM.gain_compensation(ov, 3))

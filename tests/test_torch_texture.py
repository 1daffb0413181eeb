"""Texture mapping: the port (``rtabmap_tpu_torch/maps/texture.py``,
``ops/image.bilinear_sample``) against the JAX twins on the same numpy
inputs.

The scene: the surface-net mesh of three 48x36 renders (fx = fy = 40) of
the default room's wall x = 4 m (``test_torch_tsdf_mesh.py``'s volume),
seen by the same three cameras, with their gray images and depths, and a
fourth camera that sees the wall from behind.

Tolerances and why:
- ``bilinear_sample``: 1e-6 (the same four taps and weights; float32);
- ``face_camera_scores``: which pairs score -1 exactly (integer outcome),
  the scores 1e-5 relative (cosine over z^2 in float32, the centroid and
  normal summed in another order);
- ``bake_face_atlas`` given the same scores: ``face_camera`` and the UVs
  exactly, the atlas 1e-5 (the port sums w * low over the cameras and
  divides once; the twin divides each weight first);
- ``texture_mesh`` end to end: the same, and the gains enter through the
  pairwise overlap means (float64 products on the port's side, float32
  means in the twin): atlas 1e-5;
- ``_per_camera_face_means``: 1e-6;
- the PNG and textured OBJ files: written by one package and read by the
  other, the atlas bytes and UVs exactly (both write 6 decimals).
"""
import jax
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.maps import texture as JX
from rtabmap_tpu.ops import image as JIM
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.maps import texture as X
from rtabmap_tpu_torch.maps import tsdf as TS
from rtabmap_tpu_torch.ops import image as IM
from torch_port_threads import one_torch_thread  # noqa: F401

CAM = (40.0, 40.0, 23.5, 17.5, 48, 36)


@pytest.fixture(scope="module")
def scene():
    """The inputs, made once by the port on the CPU (its renderer, TSDF and
    surface nets equal the twins', tests/test_torch_tsdf_mesh.py), as numpy
    arrays for both sides."""
    cam = C.CameraModel.make(*CAM)
    poses = S.loop_trajectory(24)[[0, 1, 2]]
    frames = [tuple(x.numpy() for x in S.render(p, cam, device="cpu")) for p in poses]
    vol = TS.TSDFVolume((3.2, -0.8, -0.6), (1.6, 1.6, 1.6), voxel=0.08, device="cpu")
    for p, (_, d) in zip(poses, frames):
        vol.integrate(d, p, cam)
    verts, faces = (x.numpy() for x in vol.extract_mesh())
    behind = np.array(poses[0])
    behind[:, :3] = behind[:, :3] @ np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    behind[0, 3] = 6.0
    poses = [*poses, behind]
    grays = [g for g, _ in frames] + [frames[0][0]]
    depths = [d for _, d in frames] + [frames[0][1]]
    return verts, faces, poses, grays, depths


def _t(a):
    return torch.from_numpy(np.array(a))


def _twin_scores(verts, faces, poses, depths):
    """The twin's face_camera_scores in one compile, rather than its
    vmapped operations one by one."""
    jcam = JC.CameraModel.make(*CAM)
    return np.asarray(jax.jit(lambda v, f, p, d: JX.face_camera_scores(v, f, p, jcam, depths=d))(
        verts, faces, poses, depths))


def test_bilinear_sample_matches_the_twin():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, 9, 11)).astype(np.float32)
    uv = rng.uniform(-2, 12, size=(2, 50, 2)).astype(np.float32)
    uv[0, :4] = [[0, 0], [10, 8], [10.5, 3], [-0.5, 8.5]]       # edges and corners
    for pad in (0.0, -1.0):
        np.testing.assert_allclose(IM.bilinear_sample(_t(img), _t(uv), pad).numpy(),
                                   np.asarray(JIM.bilinear_sample(img, uv, pad)), atol=1e-6)


def test_face_camera_scores_match_the_twin(scene):
    verts, faces, poses, _, depths = scene
    assert len(faces) > 100
    for dz in (None, depths):
        js = _twin_scores(verts, faces, poses, dz)
        ts = X.face_camera_scores(_t(verts), _t(faces), poses, C.CameraModel.make(*CAM),
                                  depths=dz).numpy()
        np.testing.assert_array_equal(ts > 0, js > 0)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
        assert (js[:3] > 0).mean() > 0.3 and not (js[3] > 0).any()


def test_bake_face_atlas_matches_the_twin(scene):
    verts, faces, poses, grays, depths = scene
    jcam, cam = JC.CameraModel.make(*CAM), C.CameraModel.make(*CAM)
    scores = _twin_scores(verts, faces, poses, depths)
    gains = np.array([1.0, 0.9, 1.1, 1.0], np.float32)
    for multiband in (True, False):
        jm = JX.bake_face_atlas(verts, faces, poses, jcam, grays, scores=scores, texel=4,
                                gains=gains, multiband=multiband)
        tm = X.bake_face_atlas(_t(verts), _t(faces), poses, cam, grays, scores=_t(scores),
                               texel=4, gains=gains, multiband=multiband)
        np.testing.assert_array_equal(tm.face_camera.numpy(), jm.face_camera)
        np.testing.assert_array_equal(tm.uvs.numpy(), jm.uvs)
        np.testing.assert_allclose(tm.atlas.numpy(), jm.atlas, atol=1e-5)
        assert (jm.face_camera >= 0).mean() > 0.5


def test_texture_mesh_and_gain_means_match_the_twin(scene):
    verts, faces, poses, grays, depths = scene
    jcam, cam = JC.CameraModel.make(*CAM), C.CameraModel.make(*CAM)
    cent = verts[faces].mean(axis=1).astype(np.float32)
    jmeans = np.stack(JX._per_camera_face_means(cent, poses, jcam, grays))
    means = X._per_camera_face_means(_t(cent), poses, cam, grays).numpy()
    np.testing.assert_allclose(means, jmeans, atol=1e-6)
    jm = JX.texture_mesh(verts, faces, poses, jcam, grays, depths=depths, texel=4)
    tm = X.texture_mesh(_t(verts), _t(faces), poses, cam, grays, depths=depths, texel=4)
    np.testing.assert_array_equal(tm.face_camera.numpy(), jm.face_camera)
    np.testing.assert_allclose(tm.atlas.numpy(), jm.atlas, atol=1e-5)


def test_textured_obj_and_png_cross_packages(tmp_path, scene):
    verts, faces, poses, grays, _ = scene
    tm = X.bake_face_atlas(_t(verts), _t(faces), poses[:3], C.CameraModel.make(*CAM),
                           grays[:3], texel=4)
    X.write_textured_obj(str(tmp_path / "port.obj"), tm)
    jm = JX.TexturedMesh(verts, faces, tm.uvs.numpy(), tm.atlas.numpy(),
                         tm.face_camera.numpy())
    JX.write_textured_obj(str(tmp_path / "jax.obj"), jm)
    for suffix in (".obj", ".mtl", ".png"):
        assert ((tmp_path / f"port{suffix}").read_bytes().replace(b"port", b"jax")
                == (tmp_path / f"jax{suffix}").read_bytes()), suffix
    for read in (X.read_textured_obj, JX.read_textured_obj):
        v, f, uv, atlas = read(str(tmp_path / "port.obj"))
        np.testing.assert_allclose(v, verts, atol=5e-7)
        np.testing.assert_array_equal(f, faces)
        np.testing.assert_allclose(uv, tm.uvs.numpy(), atol=5e-7)
        np.testing.assert_array_equal(
            atlas, (np.clip(tm.atlas.numpy(), 0, 1) * 255.0 + 0.5).astype(np.uint8))
    rgb = np.random.default_rng(0).uniform(size=(7, 9, 3)).astype(np.float32)
    X.write_png(str(tmp_path / "a.png"), rgb)
    JX.write_png(str(tmp_path / "b.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(X.read_png(str(tmp_path / "b.png")),
                                  JX.read_png(str(tmp_path / "a.png")))

"""The classical response maps and detectors: the port on the CPU against
the JAX package on one rendered 160x120 frame (max_kp=64).

Tolerances, with their reasons:
- response maps: within 1e-5 of the map's largest magnitude (the banded
  blur products of GFTT, Harris and DoG sum the same terms in another
  order; FAST's ring sum is the same float32 ops in the same order);
- detect_and_describe, for every detector: the same valid set at the same
  integer peaks, the subpixel position within 1e-3 px, the orientation
  within 1e-4 rad, and the BRIEF bits equal on the valid keypoints;
- a registered plugin detector runs through detect_and_describe like the
  built-in ones, and gives the same keypoints as the same plugin in the
  twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.ops import features as JF
from rtabmap_tpu_torch.ops import features as TF
from torch_port_threads import one_torch_thread  # noqa: F401

W, H, MAX_KP = 160, 120, 64
DETECTORS = ("gftt", "harris", "dog", "fast")


@pytest.fixture(scope="module")
def gray():
    jc = JC.CameraModel.make(150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
    g, _ = JS.render(jnp.asarray(np.asarray(JS.loop_trajectory(12))[5]), jc)
    return np.asarray(g)


@pytest.mark.parametrize("name", DETECTORS)
def test_response_maps_match(gray, name):
    rj = np.asarray(JF.RESPONSE_FNS[name](jnp.asarray(gray)))
    rt = TF.RESPONSE_FNS[name](torch.from_numpy(gray.copy())).numpy()
    assert rt.shape == rj.shape and np.abs(rj).max() > 0
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-5 * np.abs(rj).max())


def _same_keypoints(kt, dt, kj, dj):
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    uvj, uvt = np.asarray(kj.uv)[vj], kt.uv.numpy()[vt]
    np.testing.assert_array_equal(np.round(uvt), np.round(uvj))
    np.testing.assert_allclose(uvt, uvj, atol=1e-3)
    np.testing.assert_allclose(kt.angle.numpy()[vt], np.asarray(kj.angle)[vj], atol=1e-4)
    np.testing.assert_array_equal(dt.numpy()[vt], np.asarray(dj)[vj])
    assert np.all(dt.numpy()[~vt] == 0)
    return int(vj.sum())


def test_detect_and_describe_every_detector(gray):
    for name in DETECTORS:
        kj, dj = JF.detect_and_describe(jnp.asarray(gray), MAX_KP, detector=name)
        kt, dt = TF.detect_and_describe(torch.from_numpy(gray.copy()), MAX_KP, detector=name)
        assert _same_keypoints(kt, dt, kj, dj) >= 16, name


def test_register_detector(gray):
    """A plugin: the Laplacian magnitude of the blurred image, the same
    function written once for each package."""
    from rtabmap_tpu.ops import image as JI
    from rtabmap_tpu_torch.ops import image as TI

    def lap(im, blur, g):
        b = blur(g, 1.5)
        return abs(b[1:-1, :-2] + b[1:-1, 2:] + b[:-2, 1:-1] + b[2:, 1:-1] - 4 * b[1:-1, 1:-1])

    JF.register_detector("laplace", lambda g: jnp.pad(lap(jnp, JI.gaussian_blur, g), 1))
    TF.register_detector("laplace", lambda g: torch.nn.functional.pad(
        lap(torch, TI.gaussian_blur, g), (1, 1, 1, 1)))
    try:
        kj, dj = JF.detect_and_describe(jnp.asarray(gray), MAX_KP, detector="laplace")
        kt, dt = TF.detect_and_describe(torch.from_numpy(gray.copy()), MAX_KP,
                                        detector="laplace")
        assert _same_keypoints(kt, dt, kj, dj) >= 16
    finally:
        del JF.RESPONSE_FNS["laplace"], TF.RESPONSE_FNS["laplace"]
    with pytest.raises(KeyError):
        TF.detect_and_describe(torch.from_numpy(gray.copy()), MAX_KP, detector="laplace")

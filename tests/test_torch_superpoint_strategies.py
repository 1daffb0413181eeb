"""``FeatureExtractor``'s learned strategies (``Kp/DetectorStrategy`` 11,
15, 16) against the JAX twin's on the 64x96 render of
tests/test_torch_superpoint.py, with its tolerances: keypoints and
binary descriptors exactly, descf within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rtabmap_tpu.core.frame import FeatureExtractor as JFeatureExtractor
from rtabmap_tpu.datasets import synthetic as JS
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.models import superpoint as JSP
from rtabmap_tpu.ops import features as JF
from rtabmap_tpu.utils.params import Parameters as JParameters
from rtabmap_tpu_torch.core.frame import FeatureExtractor
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.models import superpoint as SP
from rtabmap_tpu_torch.ops import features as F
from rtabmap_tpu_torch.utils.params import Parameters
from torch_port_threads import one_torch_thread  # noqa: F401
from test_torch_superpoint import CAM, frame, params  # noqa: F401


@pytest.mark.parametrize("strategy", [11, 15, 16])
def test_feature_extractor_learned_strategies(frame, strategy):
    over = {"Kp/DetectorStrategy": strategy, "SuperPointRpautrat/Threshold": 0.02,
            "SuperPoint/NMSRadius": 3}
    cam = C.CameraModel.make(*CAM)
    fe = FeatureExtractor(cam, Parameters(over), max_kp=48, device="cpu")
    jfe = JFeatureExtractor(JC.CameraModel.make(*CAM), JParameters(over), max_kp=48)
    assert fe.learned and fe._sp_nms == jfe._sp_nms == 7
    assert fe._sp_threshold == jfe._sp_threshold == (0.02 if strategy == 16 else 0.01)
    g, d = frame
    fr, descf = fe.extract(g, d)
    assert descf is not None and descf.shape == (48, 256)
    # given the same network outputs both extractors' post-processing agree
    jl, jd = jax.jit(lambda p, x: JSP.SuperPointNet().apply({"params": p}, x))(
        jfe._sp.params, jnp.asarray(g)[None, :, :, None])
    kps, desc, df = SP.postprocess(torch.from_numpy(np.asarray(jl)),
                                   torch.from_numpy(np.asarray(jd)), 48, fe._sp_nms,
                                   fe._sp_threshold)
    jfr, jdescf = jfe.extract(jnp.asarray(g), jnp.asarray(d))
    np.testing.assert_array_equal(kps.uv.numpy(), np.asarray(jfr.uv))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jfr.desc))
    # the depth lookup at those keypoints
    pts, ok = F.keypoints_3d_from_depth(kps, torch.from_numpy(d), cam)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jfr.valid3d))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jfr.pts3d), atol=1e-5)
    assert int(ok.sum()) > 0 and int(fr.valid3d.sum()) > 0

"""Both engines keep a rotation that the odometry hands them off SO(3).

Twelve ticks of tests/test_torch_engine_rgbd.py's way (160x120, 128
keypoints, ground-truth odometry) through the JAX engine and the port's on
the CPU, the fourth odometry pose's rotation scaled by 1.02, as the F2M
odometry hands some frames over (|R^T R - I| up to 0.013 on a 320x240
sessions run on the CPU, 0.0094 at full width on the card). Prints
|R^T R - I| of every optimized pose in both packages.

Usage: PYTHONPATH=. python scripts/off_so3_rotation.py
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp
from rtabmap_tpu.engine.rtabmap import Rtabmap as JR
from rtabmap_tpu.core.frame import FrameFeatures as JF
from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.utils.params import Parameters as JP
from rtabmap_tpu_torch.core.frame import extract_features, FrameFeatures
from rtabmap_tpu_torch.datasets import synthetic as S
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.utils.params import Parameters

jax.config.update('jax_platforms', 'cpu')
CAM = (120.0, 120.0, 80.0, 60.0, 160, 120)
cam = C.CameraModel.make(*CAM)
way = list(range(9)) + [2, 1, 0]
poses = S.loop_trajectory(48)
feats = {w: tuple(x.numpy() for x in extract_features(*S.render(poses[w], cam, device='cpu'), cam, 128)) for w in set(way)}
over = {"Tpu/VocabularyCapacity": 8192, "Mem/STMSize": 2}
js = JR(JC.CameraModel.make(*CAM), JP(over), node_capacity=32, words_per_frame=128)
ts = Rtabmap(cam, Parameters(over), node_capacity=32, words_per_frame=128, device='cpu')
def dev(P): P = np.asarray(P, np.float64); return float(np.abs(P[:, :3].T @ P[:, :3] - np.eye(3)).max())
for i, w in enumerate(way):
    odo = np.array(poses[w])
    if i == 3:
        odo[:, :3] *= 1.02       # a rotation 2% off SO(3), as a weak frame's DLT leaves one
    js.process(JF(*(jnp.asarray(x) for x in feats[w])), odo, stamp=float(i + 1))
    ts.process(FrameFeatures(*(torch.from_numpy(np.array(x)) for x in feats[w])), odo, stamp=float(i + 1))
jo, to = js.get_optimized_poses(), ts.get_optimized_poses()
print('node  jax_dev  port_dev')
for k in sorted(jo):
    print(k, '%.4f' % dev(jo[k]), '%.4f' % dev(to[k]))

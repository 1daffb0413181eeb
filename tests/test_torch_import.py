"""The PyTorch port stands alone: no jax, nothing of rtabmap_tpu, no quiet
fallback to the CPU, and chip_smoke.py refuses to run without a card."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import rtabmap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtabmap_tpu_torch.__path__, "rtabmap_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "rtabmap_tpu") or m.startswith(("jax.", "jaxlib.", "rtabmap_tpu.")))
print(len(names), bad)
assert not bad, bad
new = {"rtabmap_tpu_torch.ops.epipolar", "rtabmap_tpu_torch.core.laser_scan",
       "rtabmap_tpu_torch.sensors", "rtabmap_tpu_torch.sensors.lidar",
       "rtabmap_tpu_torch.maps.grids", "rtabmap_tpu_torch.tools.rgbd_scan"}
assert new <= set(names), sorted(new - set(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20, out.stdout


def test_entry_points_without_a_card_raise():
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.core.laser_scan import make_scan
    from rtabmap_tpu_torch.maps.grids import OccupancyGrid
    from rtabmap_tpu_torch.maps.voxel import ElevationMap, VoxelOccupancyMap
    from rtabmap_tpu_torch.sensors.lidar import LidarVLP16
    from rtabmap_tpu_torch.tools.rgbd_scan import run_mapping
    from rtabmap_tpu_torch.odometry import create_odometry
    from rtabmap_tpu_torch.odometry.scan_f2m import OdometryScanF2M
    from rtabmap_tpu_torch.ops.cuda.nn3d import nn3d
    from rtabmap_tpu_torch.ops.cuda.vocab_knn import knn2
    from rtabmap_tpu_torch.tools.lidar_mapping import run_lidar_mapping
    from rtabmap_tpu_torch.utils.params import Parameters
    from rtabmap_tpu_torch.vocab.dictionary import VWDictionary

    cam = C.CameraModel.make(100.0, 100.0, 80.0, 60.0, 160, 120)
    p = Parameters({"RGBD/Enabled": False, "Tpu/VocabularyCapacity": 1024})
    q = torch.zeros((4, 256), dtype=torch.int8, device="meta")
    s = torch.zeros((8, 256), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError):
        knn2(q, s, torch.ones(8, dtype=torch.bool, device="meta"))
    pts = torch.zeros((4, 3), device="meta")
    with pytest.raises(RuntimeError):
        nn3d(pts, pts, torch.ones(4, dtype=torch.bool, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None selects it")
    lidar_p = Parameters({"Reg/Strategy": 1})
    scan = (np.zeros((8, 3), np.float32), np.ones(8, bool))
    from rtabmap_tpu_torch.odometry.f2m import OdometryF2M
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset

    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu_torch.memory.memory import LINK_NEIGHBOR, Link
    from rtabmap_tpu_torch.optim.pose_graph import optimize_poses_dict
    from rtabmap_tpu_torch.tools.rgbd_sessions import iter_sessions

    rgbd_p = Parameters({"Tpu/VocabularyCapacity": 1024})
    db = Database(":memory:", async_writes=False)
    eye = np.eye(3, 4, dtype=np.float32)
    for make in (lambda: Rtabmap(cam, p, node_capacity=16, words_per_frame=8),
                 lambda: Rtabmap.load(db, cam, rgbd_p, node_capacity=16, words_per_frame=8),
                 lambda: next(iter_sessions(":memory:")),
                 lambda: optimize_poses_dict({1: eye, 2: eye},
                                             [Link(1, 2, LINK_NEIGHBOR, eye, np.eye(6))]),
                 lambda: Rtabmap(cam, rgbd_p, node_capacity=16, words_per_frame=8),
                 lambda: OdometryF2M(cam),
                 lambda: create_odometry(cam, rgbd_p),
                 lambda: run_dataset([], cam, rgbd_p, verbose=False),
                 lambda: FeatureExtractor(cam, p),
                 lambda: VWDictionary(capacity=1024),
                 lambda: OdometryScanF2M(),
                 lambda: create_odometry(None, lidar_p),
                 lambda: run_lidar_mapping([scan]),
                 lambda: VoxelOccupancyMap(),
                 lambda: ElevationMap(),
                 lambda: OccupancyGrid(),
                 lambda: LidarVLP16([]),
                 lambda: make_scan(np.zeros((4, 3), np.float32)),
                 lambda: run_mapping("parity")):
        with pytest.raises(RuntimeError):
            make()
    db.close()


def test_unported_paths_raise_not_implemented():
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.utils.params import Parameters

    cam = C.CameraModel.make(100.0, 100.0, 80.0, 60.0, 160, 120)
    Rtabmap(cam, Parameters({"Tpu/VocabularyCapacity": 1024}), node_capacity=16,
            words_per_frame=8, device="cpu")          # the RGB-D tick is ported
    with pytest.raises(NotImplementedError):
        Rtabmap(cam, Parameters({"RGBD/Enabled": False}), mesh=object(), device="cpu")
    for strategy in (2, 11):   # FAST/BRIEF, SuperPoint
        with pytest.raises(NotImplementedError):
            FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": strategy}),
                             device="cpu")
    slam = Rtabmap(cam, Parameters({"RGBD/Enabled": False,
                                    "Tpu/VocabularyCapacity": 1024}),
                   node_capacity=16, words_per_frame=8, device="cpu")
    for what in ({"landmarks": [object()]}, {"descf": np.zeros((8, 256), np.float32)}):
        with pytest.raises(NotImplementedError):
            slam.process(None, np.eye(3, 4), **what)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script-alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA card is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

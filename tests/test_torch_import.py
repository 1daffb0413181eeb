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
             if m in ("jax", "jaxlib", "flax", "rtabmap_tpu")
             or m.startswith(("jax.", "jaxlib.", "flax.", "rtabmap_tpu.")))
print(len(names), bad)
assert not bad, bad
new = {"rtabmap_tpu_torch.ops.epipolar", "rtabmap_tpu_torch.core.laser_scan",
       "rtabmap_tpu_torch.sensors", "rtabmap_tpu_torch.sensors.lidar",
       "rtabmap_tpu_torch.maps.grids", "rtabmap_tpu_torch.tools.rgbd_scan",
       "rtabmap_tpu_torch.maps.tsdf", "rtabmap_tpu_torch.maps.mesh",
       "rtabmap_tpu_torch.maps.texture", "rtabmap_tpu_torch.memory.db_reader",
       "rtabmap_tpu_torch.tools.cli", "rtabmap_tpu_torch.tools.export_poses",
       "rtabmap_tpu_torch.ops.stereo", "rtabmap_tpu_torch.ops.flow",
       "rtabmap_tpu_torch.odometry.imu_filter", "rtabmap_tpu_torch.datasets.png",
       "rtabmap_tpu_torch.datasets.layouts", "rtabmap_tpu_torch.tools.stereo_datasets",
       "rtabmap_tpu_torch.models", "rtabmap_tpu_torch.models.superpoint",
       "rtabmap_tpu_torch.models.superglue", "rtabmap_tpu_torch.models.superglue_official",
       "rtabmap_tpu_torch.models.netvlad", "rtabmap_tpu_torch.models.convert",
       "rtabmap_tpu_torch.tools.navigation", "rtabmap_tpu_torch.optim",
       "rtabmap_tpu_torch.ops.registration", "rtabmap_tpu_torch.odometry.f2f",
       "rtabmap_tpu_torch.odometry.motion_filter", "rtabmap_tpu_torch.odometry.mono",
       "rtabmap_tpu_torch.tools.odometries"}
assert new <= set(names), sorted(new - set(names))
# the readers decode PNG and read sensor.yaml themselves (tools/bow_mapping.py
# imports PIL only when it reads the JPEG samples)
assert not [m for m in sys.modules if m.split(".")[0] in ("PIL", "yaml")], "PIL or yaml"
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

    from rtabmap_tpu_torch.maps.tsdf import TSDFVolume
    from rtabmap_tpu_torch.memory.db_reader import DBReader, database_recovery
    from rtabmap_tpu_torch.tools import cli
    from rtabmap_tpu_torch.tools.navigation import navigate

    from rtabmap_tpu_torch.models import superglue_official
    from rtabmap_tpu_torch.models.netvlad import GlobalDescriptorIndex, NetVLAD
    from rtabmap_tpu_torch.models.superglue import SuperGlueMatcher
    from rtabmap_tpu_torch.models.superpoint import SuperPoint

    rgbd_p = Parameters({"Tpu/VocabularyCapacity": 1024})
    learned_p = Parameters({"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6})
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
                 lambda: FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": 1})),
                 lambda: create_odometry(cam, Parameters({"Odom/Strategy": 1})),
                 lambda: create_odometry(cam, None, strategy="mono"),
                 lambda: VWDictionary(capacity=1024),
                 lambda: OdometryScanF2M(),
                 lambda: create_odometry(None, lidar_p),
                 lambda: run_lidar_mapping([scan]),
                 lambda: VoxelOccupancyMap(),
                 lambda: ElevationMap(),
                 lambda: OccupancyGrid(),
                 lambda: LidarVLP16([]),
                 lambda: make_scan(np.zeros((4, 3), np.float32)),
                 lambda: run_mapping("parity"),
                 lambda: TSDFVolume((0, 0, 0), (1, 1, 1), 0.1),
                 lambda: DBReader(db),
                 lambda: database_recovery(":memory:", ":memory:"),
                 lambda: cli.main(["reprocess", ":memory:"]),
                 lambda: cli.main(["db_edit", ":memory:", "set_label", "1", "dock"]),
                 lambda: navigate(":memory:"),
                 lambda: cli.main(["detect_more_loop_closures", ":memory:"]),
                 lambda: cli.main(["global_ba", ":memory:"]),
                 lambda: cli.main(["recovery", ":memory:", ":memory:"]),
                 lambda: cli.main(["export_cloud", ":memory:", "x.ply", "--mesh"]),
                 lambda: SuperPoint.distilled(),
                 lambda: SuperGlueMatcher.distilled(),
                 lambda: superglue_official.to_device({"bin_score": 1.0}),
                 lambda: NetVLAD(),
                 lambda: GlobalDescriptorIndex(8),
                 lambda: FeatureExtractor(cam, learned_p),
                 lambda: cli.main(["matcher", "a.png", "b.png"])):
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
    # Odom/Strategy 1 (F2F) and mono resolve to the ported odometries
    from rtabmap_tpu_torch.odometry import create_odometry
    from rtabmap_tpu_torch.odometry.f2f import OdometryF2F
    from rtabmap_tpu_torch.odometry.mono import OdometryMono

    assert isinstance(create_odometry(cam, Parameters({"Odom/Strategy": 1}), device="cpu"),
                      OdometryF2F)
    assert isinstance(create_odometry(cam, None, strategy="mono", device="cpu"), OdometryMono)
    with pytest.raises(RuntimeError):            # an external library, as in the twin
        create_odometry(cam, Parameters({"Odom/Strategy": 5}), device="cpu")
    # every classical strategy runs (tests/test_torch_detectors.py,
    # tests/test_torch_sift_lsh.py)
    for strategy in (0, 1, 2, 3, 4, 7, 9, 12, 14):
        fe = FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": strategy}), device="cpu")
        assert not fe.learned and (fe.detector, fe.descriptor) != ("gftt", "brief")
    # SuperPoint is ported (tests/test_torch_superpoint.py)
    assert FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": 11}), device="cpu").learned
    slam = Rtabmap(cam, Parameters({"RGBD/Enabled": False,
                                    "Tpu/VocabularyCapacity": 1024}),
                   node_capacity=16, words_per_frame=8, device="cpu")
    with pytest.raises(NotImplementedError):
        slam.process(None, np.eye(3, 4), landmarks=[object()])
    # Tpu/ProfileDir traces run_dataset (tests/test_torch_nav_tools.py); the
    # store and dataset tools and db_edit are ported; every other tool of
    # the twin's CLI names the slice that brings it
    from rtabmap_tpu_torch.tools import cli

    ported = {"info", "reprocess", "export", "export_cloud", "recovery",
              "detect_more_loop_closures", "global_ba", "reduce_graph", "rgbd_dataset",
              "kitti_dataset", "euroc_dataset", "cid_sims_dataset", "stereo_eval",
              "matcher", "convert_model", "db_edit"}
    assert ported < set(cli.TOOLS) and len(cli.TOOLS) == 30
    for name in sorted(set(cli.TOOLS) - ported):
        with pytest.raises(NotImplementedError, match="slice"):
            cli.main([name, "x"])


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

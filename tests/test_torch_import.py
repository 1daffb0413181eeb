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
    from rtabmap_tpu_torch.ops.cuda.vocab_knn import knn2
    from rtabmap_tpu_torch.utils.params import Parameters
    from rtabmap_tpu_torch.vocab.dictionary import VWDictionary

    cam = C.CameraModel.make(100.0, 100.0, 80.0, 60.0, 160, 120)
    p = Parameters({"RGBD/Enabled": False, "Tpu/VocabularyCapacity": 1024})
    q = torch.zeros((4, 256), dtype=torch.int8, device="meta")
    s = torch.zeros((8, 256), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError):
        knn2(q, s, torch.ones(8, dtype=torch.bool, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None selects it")
    for make in (lambda: Rtabmap(cam, p, node_capacity=16, words_per_frame=8),
                 lambda: FeatureExtractor(cam, p),
                 lambda: VWDictionary(capacity=1024)):
        with pytest.raises(RuntimeError):
            make()


def test_unported_paths_raise_not_implemented():
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.utils.params import Parameters

    cam = C.CameraModel.make(100.0, 100.0, 80.0, 60.0, 160, 120)
    with pytest.raises(NotImplementedError, match="RGB-D slice"):
        Rtabmap(cam, Parameters(), device="cpu")
    with pytest.raises(NotImplementedError):
        Rtabmap(cam, Parameters({"RGBD/Enabled": False}), db=object(), device="cpu")
    for strategy in (2, 11):   # FAST/BRIEF, SuperPoint
        with pytest.raises(NotImplementedError):
            FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": strategy}),
                             device="cpu")
    slam = Rtabmap(cam, Parameters({"RGBD/Enabled": False,
                                    "Tpu/VocabularyCapacity": 1024}),
                   node_capacity=16, words_per_frame=8, device="cpu")
    with pytest.raises(NotImplementedError):
        slam.process(None, np.eye(3, 4), scan=object())


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

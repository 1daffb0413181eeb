"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface under ``<repo>/build/`` and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. A library is rebuilt when its
source is newer. Nothing is built when a module is imported: the first
launch builds, and ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _is_fresh(name: str) -> bool:
    lib = library_path(name)
    return lib.exists() and lib.stat().st_mtime >= (CSRC / f"{name}.cu").stat().st_mtime


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources concurrently (stale ones only). Returns
    each name's compiler output (``-Xptxas=-v`` resource report); raises
    on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _is_fresh(name):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            _command(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib

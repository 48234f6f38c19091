"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

One shared library per ``csrc/<name>.cu``, each with a plain C interface (no
PyTorch headers, so a build takes seconds).  Libraries are built at first use
into a git-ignored ``build/`` directory, named by the hash of their sources so
an edited source is rebuilt; ``build_all`` starts every compiler at once.
Nothing is built or loaded when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "pte_gather", "fifo_miss")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


# src/repro_torch/kernels/_build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found on PATH: the CUDA kernels cannot "
                           "be built here")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, target: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.tmp_path, target)  # type: ignore[attr-defined]


def build_all(names: Iterable[str] = KERNELS) -> List[Path]:
    """Build every missing library, all compilers running at the same time."""
    targets = {name: _target(name) for name in names}
    procs = {name: _start(name, target)
             for name, target in targets.items() if not target.exists()}
    for name, proc in procs.items():
        _finish(name, targets[name], proc)
    return list(targets.values())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        (target,) = build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(target))
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise unless a launch function returned cudaSuccess."""
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {code}")

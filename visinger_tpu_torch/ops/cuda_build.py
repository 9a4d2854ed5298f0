"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library under ``build/visinger_tpu_torch/`` at the repository root (listed
in ``.gitignore``), then loaded with ``ctypes``.  Nothing is built when a
module is imported; ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "visinger_tpu_torch"
KERNELS = ("rel_attention", "wavenet_stack")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every stale kernel library in parallel; returns each
    compiler's output (register/shared-memory report) by kernel name."""
    started = {n: _start(n) for n in names if _stale(n)}
    logs = {}
    for name, (proc, tmp, lib) in started.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        os.replace(tmp, lib)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _libs[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")

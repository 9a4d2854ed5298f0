"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library under ``build/visinger_tpu_torch/`` at the repository root (listed
in ``.gitignore``), then loaded with ``ctypes``; it is rebuilt when the
source or a shared ``csrc/*.cuh`` header is newer than the library.  Nothing is built when a
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
    """True when the library is missing or older than its source or any
    header under ``csrc/`` (the kernels share ``tf32x3.cuh``)."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


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


def kernel_info(name: str, *shape: int) -> list[dict]:
    """Registers, dynamic shared memory (bytes) and resident blocks per SM
    of each kernel in library ``name`` at the shape arguments its
    ``<name>_info`` C function takes."""
    fn = getattr(load(name), f"{name}_info")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * (1 + len(shape))
                   + [ctypes.c_char_p, ctypes.c_int]
                   + [ctypes.POINTER(ctypes.c_int)] * 3)
    rows = []
    while True:
        label = ctypes.create_string_buffer(96)
        regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = fn(len(rows), *shape, label, len(label), ctypes.byref(regs),
                 ctypes.byref(smem), ctypes.byref(blocks))
        if err == -1:
            return rows
        check(err, f"{name}_info")
        rows.append({"kernel": label.value.decode(), "registers": regs.value,
                     "smem_bytes": smem.value,
                     "blocks_per_sm": blocks.value})


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")

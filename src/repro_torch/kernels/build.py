"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named
after a hash of its source and the flags, in ``_build/`` next to this
file (listed in ``.gitignore``).  A library is built at the first call
that needs it, or all at once by :func:`build_all`, which starts one
nvcc per source in parallel.  Nothing here runs at import time, and
nothing is built on a host without ``nvcc``: a CPU-only host never calls
into this module, because CPU tensors take the plain PyTorch route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("gemm", "conv_fused", "im2col", "flash_decode", "ssd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _start(name: str, nvcc: str):
    src, lib = _target(name)
    if os.path.exists(lib):
        return lib, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return lib, (proc, tmp, cmd)


def _finish(lib: str, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every named source not yet built, one nvcc each, all at
    once; load them.  Returns the library paths."""
    names = list(names)
    with _lock:
        pending = [n for n in names if n not in _libs]
        if pending:
            nvcc = nvcc_path()
            jobs = [(n, *_start(n, nvcc)) for n in pending]
            try:
                for _, lib, job in jobs:
                    _finish(lib, job)
            finally:
                for _, _, job in jobs:  # reap every nvcc, even after a failure
                    if job is not None and job[0].poll() is None:
                        job[0].kill()
                        job[0].wait()
            for n, lib, _ in jobs:
                _libs[n] = ctypes.CDLL(lib)
        return [_target(n)[1] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib

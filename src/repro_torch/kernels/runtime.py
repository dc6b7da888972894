"""What every kernel wrapper shares: the ctypes binding of the built
libraries, the launch checks, and one table of launch counts.

``launches`` counts kernel launches per wrapper name: one per call that
runs on the card, none for a call that takes the plain PyTorch route.
A run shows that it went through a kernel by setting the counts to 0
(:func:`reset_launches`) just before it and reading them
(:func:`launch_counts`) just after.

A CUDA graph (``kernels/graphs.py``) runs no Python when it is replayed,
so its launches are counted where it is captured: while a thread
captures, :func:`recording` gives that thread a tally of its own, which
:func:`count` fills instead of ``launches`` (the capture launches
nothing), and every replay adds the tally to ``launches``
(:func:`add_launches`) and counts one graph launch.  The tally is the
capturing thread's alone, so kernels that other threads launch meanwhile
(the old epoch's stage workers while ``swap_plan`` captures the new one)
count in ``launches`` as before and never in the graph's tally.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Mapping

import torch

from . import build

KERNEL_NAMES = (
    "conv2d_fused", "matmul_fused", "qconv2d_fused", "gemm", "im2col", "flash_decode", "ssd",
)
# the launches of csrc/gemm.cu's three entries that summed in its
# tensor-core order (gemm.order 1), each also counted under its wrapper
TENSOR_CORE_NAMES = ("conv2d_fused_tc", "matmul_fused_tc", "gemm_tc")

_count_lock = threading.Lock()
launches: Dict[str, int] = {name: 0 for name in KERNEL_NAMES + TENSOR_CORE_NAMES}
_graph_launches = 0
_capturing = threading.local()


def count(name: str) -> None:
    tally = getattr(_capturing, "tally", None)
    if tally is not None:  # being captured: counted at every replay instead
        tally[name] += 1
        return
    with _count_lock:  # stage workers launch from several threads
        launches[name] += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Count this thread's launches into a fresh tally (yielded) instead
    of ``launches``, for as long as the block runs."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {name: 0 for name in KERNEL_NAMES + TENSOR_CORE_NAMES}
    try:
        yield tally
    finally:
        _capturing.tally = outer


def add_launches(tally: Mapping[str, int]) -> None:
    """One replay of a graph whose capture recorded ``tally``."""
    global _graph_launches
    with _count_lock:
        for name, n in tally.items():
            launches[name] += n
        _graph_launches += 1


def graph_launches() -> int:
    """Graph replays since the last :func:`reset_launches`."""
    with _count_lock:
        return _graph_launches


def reset_launches() -> None:
    global _graph_launches
    with _count_lock:
        for k in launches:
            launches[k] = 0
        _graph_launches = 0


def launch_counts(tensor_cores: bool = False) -> Dict[str, int]:
    """Launches per wrapper name (``KERNEL_NAMES``) since the last reset;
    with ``tensor_cores`` also the ``TENSOR_CORE_NAMES`` counts."""
    with _count_lock:
        return {k: v for k, v in launches.items() if tensor_cores or k in KERNEL_NAMES}


# ------------------------------------------------------------ ctypes binding
P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
_bind_lock = threading.Lock()
_bound: Dict[str, object] = {}


def bind(lib_name: str, sym: str, argtypes):
    """``csrc/<lib_name>.cu``'s C function ``sym``, built and loaded on
    first use; pointers and the stream are ``P``, ints ``I``, 64-bit ints
    (strides) ``L``, floats ``F``."""
    key = f"{lib_name}:{sym}"
    fn = _bound.get(key)
    if fn is None:
        with _bind_lock:
            fn = _bound.get(key)
            if fn is None:
                fn = getattr(build.load(lib_name), sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _bound[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def require(t: torch.Tensor, name: str, ndim: int, dtype=torch.float32) -> None:
    """Raise unless ``t`` has ``ndim`` dims and ``dtype`` (one dtype, or a
    tuple of those the kernel takes)."""
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name} must be {' or '.join(map(str, allowed))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU or
    ``meta`` tensor (take the plain version); any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

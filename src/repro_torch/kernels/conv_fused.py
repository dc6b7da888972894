"""Fused conv and dense kernels of the serving hot path, with their plain
PyTorch versions and launch counts.

``conv2d_fused`` replaces the Pallas kernel
``repro/kernels/conv_fused.py::_conv_fused_kernel`` (f32 instantiation,
launched by ``_conv_fused_call``): an implicit-GEMM conv with the scale,
bias and ReLU epilogue fused into the flush.  On an H100 it is bound by
operations (18*C flops per output byte for a 3x3 conv); the CUDA kernel
in ``csrc/conv_fused.cu`` forms its input tiles on the fly from the NHWC
tensor (no im2col matrix, no padded copy) and accumulates in IEEE f32 on
the CUDA cores, so it holds the reference's tolerance.  Tensor-core
routes (TF32, bf16) with their own tolerances are later work.

``matmul_fused`` replaces ``repro/kernels/conv_fused.py::_matmul_fused_kernel``:
the fc GEMM with the same epilogue.  At the serving micro-batch it is
bound by the bytes of the weight matrix; ``csrc/matmul_fused.cu`` reads
each weight once, coalesced along N, split over K into enough blocks to
fill the card, and sums the slices in a fixed order (no atomics).

Routing is by the tensor's device alone: a CPU tensor goes to the plain
version (``fused_route_ref`` / ``matmul_fused_ref``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches per
wrapper (one per call on the card; the plain route never counts).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

_count_lock = threading.Lock()
launches: Dict[str, int] = {"conv2d_fused": 0, "matmul_fused": 0}


def _count(name: str) -> None:
    with _count_lock:  # stage workers launch from several threads
        launches[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(launches)


# ------------------------------------------------------------ ctypes binding
_P = ctypes.c_void_p
_I = ctypes.c_int
_bind_lock = threading.Lock()
_bound: Dict[str, object] = {}


def _fn(lib_name: str, sym: str, argtypes):
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


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _require(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_ones_cache: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ones(n: int, device: torch.device) -> torch.Tensor:
    """The epilogue's all-ones scale of the f32 path, made once per
    (device, length).  Its fill is synchronized before it is cached, so
    stage workers on other streams read it finished; it is never freed."""
    key = (device, n)
    t = _ones_cache.get(key)
    if t is None:
        with _bind_lock:
            t = _ones_cache.get(key)
            if t is None:
                t = torch.ones(n, device=device)
                torch.cuda.current_stream(device).synchronize()
                _ones_cache[key] = t
    return t


@functools.lru_cache(maxsize=None)
def _splits(k: int, n: int) -> int:
    """K slices of the dense kernel's first pass; the C side's formula
    depends on (K, N) alone, so one call per shape."""
    return _fn("matmul_fused", "matmul_fused_splits", [_I, _I])(k, n)


# ------------------------------------------------------------------ conv
def supports(fh: int, fw: int, stride: int, groups: int = 1) -> bool:
    """Shapes the fused kernel takes; grouped and depthwise convs keep
    their native implementation (the backend records the fallback)."""
    return groups == 1 and stride >= 1 and fh >= 1 and fw >= 1


def fused_route_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int = 1,
    pad: int = 0,
    groups: int = 1,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the fused conv: direct convolution plus
    epilogue, NHWC in and out, HWIO filters.  Also the route for shapes
    :func:`supports` rejects (grouped and depthwise convs).

    1x1 unpadded convs are the GEMM itself (strided slice + matmul), as in
    the reference's ``fused_route_ref``."""
    if groups == 1 and w.shape[0] == 1 and w.shape[1] == 1 and pad == 0:
        bsz = x.shape[0]
        xs = x[:, ::stride, ::stride, :]
        oh, ow = xs.shape[1], xs.shape[2]
        y = xs.reshape(-1, xs.shape[-1]) @ w.reshape(w.shape[2], w.shape[3])
        y = y.reshape(bsz, oh, ow, -1)
    else:
        y = F.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
            stride=stride, padding=pad, groups=groups,
        ).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return y


def conv2d_fused(
    x: torch.Tensor,  # [B, H, W, C]
    w: torch.Tensor,  # [FH, FW, C, Cout]
    b: Optional[torch.Tensor],
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Fused conv + bias + ReLU (``groups == 1``).

    CPU tensors take :func:`fused_route_ref`; CUDA tensors launch
    ``csrc/conv_fused.cu`` on the current stream.  The kernel's epilogue
    scale is ones on this f32 path; the quantized variant's merged
    requant scale will use the same operand."""
    if x.device.type == "cpu":
        return fused_route_ref(x, w, b, stride=stride, pad=pad, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_fused: unsupported device {x.device}")
    _require(x, "x", 4)
    _require(w, "w", 4)
    bsz, h, wd, c = x.shape
    fh, fw, cw, cout = w.shape
    if cw != c:
        raise ValueError(f"conv2d_fused: filter takes {cw} channels, input has {c}")
    if not supports(fh, fw, stride):
        raise ValueError(f"conv2d_fused: unsupported geometry {fh}x{fw}/s{stride}")
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wd - fw + 2 * pad) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv2d_fused: empty output {oh}x{ow}")
    dev = x.device
    bias = torch.zeros(cout, device=dev) if b is None else b
    for t, name in ((w, "w"), (bias, "bias")):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"conv2d_fused: {name} must be float32 on {dev}")
    if bias.shape != (cout,):
        raise ValueError("conv2d_fused: bias must have shape [Cout]")
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    scale = _ones(cout, dev)
    y = torch.empty((bsz, oh, ow, cout), device=dev, dtype=torch.float32)
    fn = _fn("conv_fused", "conv_fused_f32", [_P] * 5 + [_I] * 12 + [_P])
    err = fn(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        bsz, h, wd, c, fh, fw, cout, stride, pad, oh, ow, int(bool(relu)),
        _stream(dev),
    )
    _check(err, "conv_fused_f32")
    _count("conv2d_fused")
    return y


# ------------------------------------------------------------------ dense
def matmul_fused_ref(
    a: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    *,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the fused dense GEMM."""
    y = a @ w + bias
    return torch.relu(y) if relu else y


def matmul_fused(
    a: torch.Tensor,  # [M, K]
    w: torch.Tensor,  # [K, N]
    bias: torch.Tensor,  # [N]
    *,
    relu: bool = False,
) -> torch.Tensor:
    """GEMM with the dense layer's epilogue (bias, ReLU) fused.

    CPU tensors take :func:`matmul_fused_ref`; CUDA tensors launch
    ``csrc/matmul_fused.cu`` (two passes, counted as one launch of the
    wrapper) on the current stream."""
    if a.device.type == "cpu":
        return matmul_fused_ref(a, w, bias, relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_fused: unsupported device {a.device}")
    _require(a, "a", 2)
    _require(w, "w", 2)
    m, k = a.shape
    kw, n = w.shape
    if kw != k:
        raise ValueError(f"matmul_fused: inner dims differ ({k} vs {kw})")
    dev = a.device
    for t, name in ((w, "w"), (bias, "bias")):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"matmul_fused: {name} must be float32 on {dev}")
    if bias.shape != (n,):
        raise ValueError("matmul_fused: bias must have shape [N]")
    a, w, bias = a.contiguous(), w.contiguous(), bias.contiguous()
    scale = _ones(n, dev)  # the kernel's epilogue scale (f32 path)
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    # pass-1 partial sums, one [M, N] slice per K split (the C side sizes S)
    part = torch.empty((_splits(k, n), m, n), device=dev, dtype=torch.float32)
    fn = _fn("matmul_fused", "matmul_fused_f32", [_P] * 6 + [_I] * 4 + [_P])
    err = fn(
        a.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), part.data_ptr(), m, k, n, int(bool(relu)), _stream(dev),
    )
    _check(err, "matmul_fused_f32")
    _count("matmul_fused")
    return out

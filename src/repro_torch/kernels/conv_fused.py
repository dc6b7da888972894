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

``qconv2d_fused`` replaces the same Pallas kernel's int32 instantiation
(the quantized conv of ``repro/kernels/conv_fused.py::qconv2d_fused``):
int32 operands in [-255, 255], an int32 accumulator, and the merged
requant scale in the epilogue's scale operand.  It is bound by
operations at the CUDA cores' int32 rate (half the f32 FMA rate).

``matmul_fused`` replaces ``repro/kernels/conv_fused.py::_matmul_fused_kernel``:
the fc GEMM with the same epilogue.  At the serving micro-batch it is
bound by the bytes of the weight matrix; ``csrc/matmul_fused.cu`` reads
each weight once, coalesced along N, split over K into enough blocks to
fill the card, and sums the slices in a fixed order (no atomics).

Routing is by the tensor's device alone: a CPU tensor goes to the plain
version (``fused_route_ref`` / ``qfused_route_ref`` / ``matmul_fused_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` (shared with
every wrapper, ``kernels/runtime.py``) counts kernel launches per
wrapper: one per call on the card; the plain route never counts.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import runtime as R
from .runtime import launch_counts, launches, reset_launches  # noqa: F401  (re-exported)

_ones_lock = threading.Lock()
_ones_cache: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ones(n: int, device: torch.device) -> torch.Tensor:
    """The epilogue's all-ones scale of the f32 path, made once per
    (device, length).  Its fill is synchronized before it is cached, so
    stage workers on other streams read it finished; it is never freed."""
    key = (device, n)
    t = _ones_cache.get(key)
    if t is None:
        with _ones_lock:
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
    return R.bind("matmul_fused", "matmul_fused_splits", [R.I, R.I])(k, n)


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


def _conv_launch(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor],
    b: Optional[torch.Tensor],
    *,
    stride: int,
    pad: int,
    relu: bool,
    what: str,
    sym: str,
) -> torch.Tensor:
    """Check the operands and launch ``csrc/conv_fused.cu``'s entry ``sym``
    on the current stream: f32 operands for ``conv_fused_f32``, int32 for
    ``conv_fused_i32``; scale and bias are f32 either way."""
    dtype = torch.int32 if sym == "conv_fused_i32" else torch.float32
    R.require(x, "x", 4, dtype)
    R.require(w, "w", 4, dtype)
    bsz, h, wd, c = x.shape
    fh, fw, cw, cout = w.shape
    if cw != c:
        raise ValueError(f"{what}: filter takes {cw} channels, input has {c}")
    if not supports(fh, fw, stride):
        raise ValueError(f"{what}: unsupported geometry {fh}x{fw}/s{stride}")
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wd - fw + 2 * pad) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"{what}: empty output {oh}x{ow}")
    dev = x.device
    if w.device != dev:
        raise ValueError(f"{what}: w must be on {dev}")
    bias = torch.zeros(cout, device=dev) if b is None else b
    scale = _ones(cout, dev) if scale is None else scale
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 on {dev}")
        if t.shape != (cout,):
            raise ValueError(f"{what}: {name} must have shape [Cout]")
    x, w = x.contiguous(), w.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty((bsz, oh, ow, cout), device=dev, dtype=torch.float32)
    fn = R.bind("conv_fused", sym, [R.P] * 5 + [R.I] * 12 + [R.P])
    err = fn(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        bsz, h, wd, c, fh, fw, cout, stride, pad, oh, ow, int(bool(relu)),
        R.stream(dev),
    )
    R.check(err, sym)
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
    scale is ones on this f32 path; :func:`qconv2d_fused` puts the merged
    requant scale in the same operand."""
    if not R.on_card(x, "conv2d_fused"):
        return fused_route_ref(x, w, b, stride=stride, pad=pad, relu=relu)
    y = _conv_launch(
        x, w, None, b, stride=stride, pad=pad, relu=relu,
        what="conv2d_fused", sym="conv_fused_f32",
    )
    R.count("conv2d_fused")
    return y


# ------------------------------------------------------------ quantized conv
def _quantize_operands(x, qw, scale, zp, w_shape):
    """What the reference computes outside its kernel: the per-tensor
    activation quantization (over the whole batch, as ``qgemm`` does),
    both operands shifted to the zero-point-free int32 domain in
    [-255, 255], and the merged requant scale ``sa * scale`` [Cout]."""
    from ..cnn.quant import quantize_tensor

    qa, sa, za = quantize_tensor(x, axis=None)
    xq = qa.to(torch.int32) - za.to(torch.int32)
    wq = (qw.to(torch.int32) - zp.to(torch.int32)).reshape(w_shape)
    return xq, wq, (sa * scale).reshape(-1)


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact int32 direct convolution, NHWC x HWIO: the patch matrix
    times the filter through ``cnn.quant``'s exact integer product (in
    float64, so no cuDNN algorithm choice enters)."""
    from ..cnn.layers import im2col
    from ..cnn.quant import int_matmul

    fh, fw, c, cout = wq.shape
    bsz, h, wd, _ = xq.shape
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wd - fw + 2 * pad) // stride + 1
    cols = im2col(xq, fh, fw, stride, pad)  # [B, OH*OW, K], int32
    acc = int_matmul(cols.reshape(-1, cols.shape[-1]), wq.reshape(fh * fw * c, cout))
    return acc.reshape(bsz, oh, ow, cout)


def qfused_route_ref(
    x: torch.Tensor,
    qw: torch.Tensor,
    scale: torch.Tensor,
    zp: torch.Tensor,
    b: Optional[torch.Tensor],
    w_shape: Tuple[int, int, int, int],
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv2d_fused`: the same
    quantization, the exact int32 conv, then ``float(acc) * merged``
    rounded, ``+ bias`` rounded, and the optional ReLU: the kernel's
    epilogue step for step."""
    xq, wq, merged = _quantize_operands(x, qw, scale, zp, tuple(w_shape))
    y = _int_conv(xq, wq, stride, pad).to(torch.float32) * merged
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return y


def qconv2d_fused(
    x: torch.Tensor,  # [B, H, W, C] float activations
    qw: torch.Tensor,  # [FH*FW*C, Cout] uint8 (cnn.quant.quantize_graph_params)
    scale: torch.Tensor,  # [1, Cout] weight scales
    zp: torch.Tensor,  # [1, Cout] weight zero points
    b: Optional[torch.Tensor],
    w_shape: Tuple[int, int, int, int],
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """QASYMM8 conv with the requant step fused into the kernel's flush.

    The input is quantized and shifted to int32 here, in plain PyTorch,
    as the reference does outside its Pallas kernel; then the int32
    instantiation of ``csrc/conv_fused.cu`` accumulates in int32 and its
    epilogue applies the merged scale ``sa * scale[j]`` (the operand that
    holds ones on the f32 path), the bias and the ReLU.  Float 0
    quantizes to exactly ``za``, so the shifted zero is 0 and the
    kernel's masked-zero padding of the unpadded input equals the
    reference's zero-padded ``xq``.  CPU tensors take
    :func:`qfused_route_ref`."""
    if not R.on_card(x, "qconv2d_fused"):
        return qfused_route_ref(
            x, qw, scale, zp, b, w_shape, stride=stride, pad=pad, relu=relu
        )
    R.require(x, "x", 4)
    xq, wq, merged = _quantize_operands(x, qw, scale, zp, tuple(w_shape))
    y = _conv_launch(
        xq, wq, merged, b, stride=stride, pad=pad, relu=relu,
        what="qconv2d_fused", sym="conv_fused_i32",
    )
    R.count("qconv2d_fused")
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
    if not R.on_card(a, "matmul_fused"):
        return matmul_fused_ref(a, w, bias, relu=relu)
    R.require(a, "a", 2)
    R.require(w, "w", 2)
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
    fn = R.bind("matmul_fused", "matmul_fused_f32", [R.P] * 6 + [R.I] * 4 + [R.P])
    err = fn(
        a.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), part.data_ptr(), m, k, n, int(bool(relu)), R.stream(dev),
    )
    R.check(err, "matmul_fused_f32")
    R.count("matmul_fused")
    return out

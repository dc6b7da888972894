"""QASYMM8-style quantization for the CNN GEMM path (paper §VII-D).

The counterpart of ``repro/cnn/quant.py``.  ARM-CL's QASYMM8 uses
asymmetric uint8 with a scale and zero point per tensor (here per output
channel for weights, standard practice).  The paper's point is
architectural: quantization is *orthogonal* to Pipe-it: it changes layer
times (the T matrix) but not the scheduling algorithms.
``quantize_graph_params`` produces uint8 weights, and the quantized GEMM
includes the de/re-quantization work the paper measures (Fig. 13).

``torch.round`` rounds half to even, as ``jnp.round`` does.  Integer
products are taken in float64 (``F.conv2d`` and ``matmul`` take no int32
on CUDA): every partial sum is an integer below 4608 * 255 * 255 < 2**53,
so the float64 sum is exact in any order, and it rounds back to int32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_tensor(w: torch.Tensor, axis=-1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric uint8 quantization along ``axis`` (per output channel),
    or per tensor when ``axis is None``.

    Returns (q, scale, zero_point) with  w ~= scale * (q - zero_point);
    scale and zero_point keep ``w``'s rank (size 1 on the reduced axes).
    """
    if axis is None:
        reduce_axes = tuple(range(w.dim()))
    else:
        reduce_axes = tuple(i for i in range(w.dim()) if i != (axis % w.dim()))
    # amin/amax over an empty dim tuple would reduce every axis
    w_lo = w.amin(dim=reduce_axes, keepdim=True) if reduce_axes else w
    w_hi = w.amax(dim=reduce_axes, keepdim=True) if reduce_axes else w
    w_min = torch.clamp(w_lo, max=0.0)
    w_max = torch.clamp(w_hi, min=0.0)
    scale = (w_max - w_min) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(-w_min / scale), 0, 255)
    q = torch.clamp(torch.round(w / scale + zp), 0, 255).to(torch.uint8)
    return q, scale, zp


def dequantize(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    return scale * (q.to(torch.float32) - zp)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int32 matrices with entries in [-255, 255]."""
    return (a.to(torch.float64) @ b.to(torch.float64)).round().to(torch.int32)


def qgemm(a: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """Quantized GEMM: quantize activations to uint8 (per tensor), int32
    accumulate, dequantize the result: ARM-CL's QASYMM8 kernels with the
    re/de-quantization work the paper identifies as overhead."""
    qa, sa, za = quantize_tensor(a, axis=None)
    acc = int_matmul(
        qa.to(torch.int32) - za.to(torch.int32),
        qw.to(torch.int32) - zp.to(torch.int32),
    )
    return acc.to(torch.float32) * sa * scale


def quantize_graph_params(params: Dict[str, Dict[str, torch.Tensor]]):
    """Quantize every weight matrix/filter in a CNN graph's params."""
    out = {}
    for name, p in params.items():
        q, s, z = quantize_tensor(p["w"].reshape(-1, p["w"].shape[-1]), axis=-1)
        out[name] = {"qw": q, "scale": s, "zp": z, "b": p["b"], "shape": tuple(p["w"].shape)}
    return out


def make_quant_gemm_fn(qparams_entry):
    """A gemm_fn closure for ``Graph.apply(..., gemm_fn=...)`` built from
    one layer's quantized params."""
    qw = qparams_entry["qw"]
    s = qparams_entry["scale"]
    z = qparams_entry["zp"]
    return lambda a, _ignored: qgemm(a, qw, s, z)


def make_quant_conv_fn(qparams_entry, *, stride: int = 1, pad: int = 0,
                       relu: bool = False, kernel: bool = False):
    """The fused-conv counterpart of :func:`make_quant_gemm_fn`: a closure
    ``x -> y`` executing one quantized conv layer with the requant step
    fused into the kernel epilogue (`kernels/conv_fused.py`).

    ``kernel=True`` calls ``qconv2d_fused``, which launches the int32
    conv kernel on a CUDA tensor (its plain version on a CPU tensor);
    the default is the plain route ``qfused_route_ref``.  The reference
    names this flag ``pallas``."""
    from ..kernels.conv_fused import qconv2d_fused, qfused_route_ref

    qw, s, z = qparams_entry["qw"], qparams_entry["scale"], qparams_entry["zp"]
    b, shape = qparams_entry["b"], tuple(qparams_entry["shape"])
    fn = qconv2d_fused if kernel else qfused_route_ref
    return lambda x: fn(x, qw, s, z, b, shape, stride=stride, pad=pad, relu=relu)

"""Fused conv and dense kernels of the serving hot path, with their plain
PyTorch versions and launch counts.

``conv2d_fused`` replaces the Pallas kernel
``repro/kernels/conv_fused.py::_conv_fused_kernel`` (f32 instantiation,
launched by ``_conv_fused_call``): an implicit-GEMM conv with the bias
and ReLU epilogue fused into the flush.  ``matmul_fused`` replaces
``repro/kernels/conv_fused.py::_matmul_fused_kernel``: the fc GEMM with
the same epilogue.  Both are entries of ``csrc/gemm.cu`` (``conv_fused_f32``,
``matmul_fused_f32``) on the machinery of the unfused route's GEMM (B3):

* the conv runs B3's tiled kernel (register tiles on a ``cp.async`` ring
  of shared-memory stages, the tile variant chosen from (M, K, N)) with
  an A loader that gathers the patch matrix's rows from the unpadded
  NHWC input (``ImplicitA``: a per-block table of each output pixel's
  input offset, one filter tap per k-step where ``C % BK == 0``, padding
  taps zero-filled by the copy) and a bias/ReLU epilogue.  On an H100 it
  is bound by operations (18*C flops per output for a 3x3 conv) at the
  CUDA cores' f32 FMA rate: it stays in IEEE f32 (no TF32), so the
  reference's tolerance holds.
* the fc GEMM runs B3's split-K skinny kernel for the serving
  micro-batch (M <= 8; 8 weight rows in flight a thread, float4 loads),
  and its second pass applies the epilogue; larger M take the tiled
  kernel.  At the micro-batch it is bound by the bytes of the weights.

Both sum every output in B3's order, fixed by (K, N) alone: K cut into
slices of ``gemm_slice_len(K, N)`` rows, each one ``fmaf`` chain, the
slice sums added in order; the epilogue adds the bias with one rounded
add.  So a row's bits do not depend on the batch it rides in, and the
``cuda_fused`` route gives the bits of the ``cuda`` route (``im2col`` +
``gemm``, then ``+ b`` and ReLU).  :func:`conv2d_fused_tiled` forces a
tile variant, for checks that all give the same bits.

``qconv2d_fused`` replaces the same Pallas kernel's int32 instantiation
(the quantized conv of ``repro/kernels/conv_fused.py::qconv2d_fused``):
``csrc/conv_fused.cu``, int32 operands in [-255, 255], an int32
accumulator, and the merged requant scale in its epilogue.  It is bound
by operations at the CUDA cores' int32 rate (half the f32 FMA rate).

Routing is by the tensor's device alone: a CPU tensor goes to the plain
version (``fused_route_ref`` / ``qfused_route_ref`` / ``matmul_fused_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` (shared with
every wrapper, ``kernels/runtime.py``) counts kernel launches per
wrapper: one per call on the card; the plain route never counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import gemm as G
from . import runtime as R
from .runtime import launch_counts, launches, reset_launches  # noqa: F401  (re-exported)

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
    variant: int = -1,
) -> torch.Tensor:
    """Check the operands and launch a fused conv on the current stream:
    f32 operands (``scale`` None) go to ``csrc/gemm.cu``'s
    ``conv_fused_f32`` on tile variant ``variant`` (-1: chosen from the
    shape); int32 operands to ``csrc/conv_fused.cu``'s ``conv_fused_i32``
    with the f32 ``scale``.  Bias is f32 either way."""
    dtype = torch.float32 if scale is None else torch.int32
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
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 on {dev}")
        if t.shape != (cout,):
            raise ValueError(f"{what}: {name} must have shape [Cout]")
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    scale = None if scale is None else scale.contiguous()
    y = torch.empty((bsz, oh, ow, cout), device=dev, dtype=torch.float32)
    geometry = (bsz, h, wd, c, fh, fw, cout, stride, pad, oh, ow, int(bool(relu)))
    if scale is None:
        fn = R.bind("gemm", "conv_fused_f32", [R.P] * 4 + [R.I] * 13 + [R.P])
        err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), *geometry,
                 int(variant), R.stream(dev))
        R.check(err, "conv_fused_f32")
    else:
        fn = R.bind("conv_fused", "conv_fused_i32", [R.P] * 5 + [R.I] * 12 + [R.P])
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), *geometry, R.stream(dev))
        R.check(err, "conv_fused_i32")
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
    ``csrc/gemm.cu``'s ``conv_fused_f32`` on the current stream."""
    if not R.on_card(x, "conv2d_fused"):
        return fused_route_ref(x, w, b, stride=stride, pad=pad, relu=relu)
    y = _conv_launch(x, w, None, b, stride=stride, pad=pad, relu=relu, what="conv2d_fused")
    R.count("conv2d_fused")
    return y


def conv2d_fused_tiled(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    variant: int,
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """:func:`conv2d_fused` on tile variant ``variant`` (0 ..
    ``gemm.tile_variants() - 1``), on CUDA tensors only: for checks that
    every variant gives the same bits.  Counts no launch (the main path
    never calls it)."""
    if not R.on_card(x, "conv2d_fused_tiled"):
        raise ValueError("conv2d_fused_tiled runs on the card only")
    if not 0 <= variant < G.tile_variants():
        raise ValueError(f"conv2d_fused_tiled: no tile variant {variant}")
    return _conv_launch(x, w, None, b, stride=stride, pad=pad, relu=relu,
                        what="conv2d_fused_tiled", variant=variant)


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
    y = _conv_launch(xq, wq, merged, b, stride=stride, pad=pad, relu=relu, what="qconv2d_fused")
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
    ``csrc/gemm.cu``'s ``matmul_fused_f32`` on the current stream (for M
    <= 8 two passes, the split-K partials and their ordered sum with the
    epilogue; counted as one launch of the wrapper)."""
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
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    part = G.partials(m, k, n, dev)  # the skinny path's split-K partials
    fn = R.bind("gemm", "matmul_fused_f32", [R.P] * 5 + [R.I] * 4 + [R.P])
    err = fn(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, k, n, int(bool(relu)), R.stream(dev),
    )
    R.check(err, "matmul_fused_f32")
    R.count("matmul_fused")
    return out

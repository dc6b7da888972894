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
  is bound by operations (18*C flops per output for a 3x3 conv).  Where
  K = FH*FW*C is a multiple of 16 and at least 64 (``gemm.order`` 1: every
  VGG-16 conv but conv1_1) they run on the TF32 tensor cores on operands
  split into two TF32 terms each, three term products kept (165 TFLOP/s
  of f32 work); elsewhere in IEEE ``fmaf`` on the CUDA cores (67
  TFLOP/s).  Either way the sums keep f32 accuracy, so the reference's
  tolerance holds.
* the fc GEMM runs B3's split-K skinny kernel for the serving
  micro-batch (M <= 8; in order 0 8 weight rows in flight a thread,
  float4 loads; in order 1 a warpgroup's fragments of the weights read
  straight from device memory, the M rows padded to 8 with zeros), and
  its second pass applies the epilogue; larger M take the tiled kernel.
  At the micro-batch it is bound by the bytes of the weights.

Both sum every output in B3's order, fixed by (K, N) alone: K cut into
slices of ``gemm_slice_len(K, N)`` rows, each one ``fmaf`` chain (order
0) or a chain of 32-deep tensor-core steps, each folded in by one IEEE
add (order 1), the slice sums added in order; the epilogue adds the bias
with one rounded add.  So a row's bits do not depend on the batch it rides in, and the
``cuda_fused`` route gives the bits of the ``cuda`` route (``im2col`` +
``gemm``, then ``+ b`` and ReLU).  :func:`conv2d_fused_tiled` forces a
tile variant, for checks that all give the same bits.

``qconv2d_fused`` replaces the same Pallas kernel's int32 instantiation
(the quantized conv of ``repro/kernels/conv_fused.py::qconv2d_fused``):
``csrc/conv_fused.cu``'s ``qconv_u8`` multiplies the unshifted u8
operands on the int8 tensor cores (``mma.sync`` m16n8k32, int32 sums),
corrects for the zero points from the row sums it takes itself and the
layer's column sums, and applies the merged requant scale in its
epilogue; the result is the exact int32 sum of the shifted operands, so
the output is bitwise equal to :func:`qfused_route_ref`.  At VGG-16's
shapes it is bound by the bytes of its f32 output.

Routing is by the tensor's device alone: a CPU tensor goes to the plain
version (``fused_route_ref`` / ``qfused_route_ref`` / ``matmul_fused_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` (shared with
every wrapper, ``kernels/runtime.py``) counts kernel launches per
wrapper: one per call on the card, and one more under
``conv2d_fused_tc`` / ``matmul_fused_tc`` where the call summed in order
1 (``launch_counts(tensor_cores=True)``); the plain route never counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from . import gemm as G
from . import runtime as R
from .config import ieee_f32_convs
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
        if x.is_cuda:
            ieee_f32_convs()
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
    b: Optional[torch.Tensor],
    *,
    stride: int,
    pad: int,
    relu: bool,
    what: str,
    variant: int = -1,
) -> torch.Tensor:
    """Check the operands and launch ``csrc/gemm.cu``'s ``conv_fused_f32``
    on the current stream, on tile variant ``variant`` (-1: chosen from
    the shape)."""
    R.require(x, "x", 4)
    R.require(w, "w", 4)
    bsz, h, wd, c = x.shape
    fh, fw, cw, cout = w.shape
    if cw != c:
        raise ValueError(f"{what}: filter takes {cw} channels, input has {c}")
    oh, ow = _out_size(h, wd, fh, fw, stride, pad, what)
    dev = x.device
    if w.device != dev:
        raise ValueError(f"{what}: w must be on {dev}")
    bias = torch.zeros(cout, device=dev) if b is None else b
    _check_f32(bias, "bias", (cout,), dev, what)
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    y = torch.empty((bsz, oh, ow, cout), device=dev, dtype=torch.float32)
    fn = R.bind("gemm", "conv_fused_f32", [R.P] * 4 + [R.I] * 13 + [R.P])
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
             bsz, h, wd, c, fh, fw, cout, stride, pad, oh, ow, int(bool(relu)),
             int(variant), R.stream(dev))
    R.check(err, "conv_fused_f32")
    return y


def _out_size(h: int, wd: int, fh: int, fw: int, stride: int, pad: int, what: str):
    if not supports(fh, fw, stride):
        raise ValueError(f"{what}: unsupported geometry {fh}x{fw}/s{stride}")
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wd - fw + 2 * pad) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"{what}: empty output {oh}x{ow}")
    return oh, ow


def _check_f32(t: torch.Tensor, name: str, shape: Tuple[int, ...], dev: torch.device, what: str) -> None:
    """``t`` must be a float32 tensor of ``shape`` on ``dev``."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32 on {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must have shape {list(shape)}, got {list(t.shape)}")


def conv2d_fused(
    x: torch.Tensor,  # [B, H, W, C]
    w: torch.Tensor,  # [FH, FW, C, Cout]
    b: Optional[torch.Tensor],
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
    variant: int = -1,
) -> torch.Tensor:
    """Fused conv + bias + ReLU (``groups == 1``).

    CPU tensors take :func:`fused_route_ref`; CUDA tensors launch
    ``csrc/gemm.cu``'s ``conv_fused_f32`` on the current stream, on tile
    variant ``variant`` (``-1``: chosen by the kernel from the shape;
    ``kernels/autotune.py`` picks one by time).  Every variant gives the
    same bits."""
    if not R.on_card(x, "conv2d_fused"):
        return fused_route_ref(x, w, b, stride=stride, pad=pad, relu=relu)
    if not -1 <= variant < G.tile_variants():
        raise ValueError(f"conv2d_fused: no tile variant {variant}")
    y = _conv_launch(x, w, b, stride=stride, pad=pad, relu=relu, what="conv2d_fused",
                     variant=variant)
    R.count("conv2d_fused")
    if G.order(w.shape[0] * w.shape[1] * w.shape[2], w.shape[3]):
        R.count("conv2d_fused_tc")
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
    return _conv_launch(x, w, b, stride=stride, pad=pad, relu=relu,
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


def pack_weights(qw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filter operand of ``qconv_u8`` for ``qw`` [K, Cout] u8: its
    transpose ``wt`` [Cout, Kp] (k contiguous, as the tensor cores' B
    operand wants it; zero past K up to Kp, K rounded up to 16) and its
    column sums ``colsum`` [Cout] int32, by a copy and a sum in plain
    PyTorch."""
    k, cout = qw.shape
    wt = torch.zeros((cout, -(-k // 16) * 16), dtype=torch.uint8, device=qw.device)
    wt[:, :k] = qw.t()
    return wt, qw.sum(0, dtype=torch.int32)


_packed = WeakIdKeyDictionary()  # qw -> (qw._version, wt, colsum)


def packed_weights(qw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_weights` of ``qw``, made once per weight tensor and kept
    while ``qw`` lives and is not modified in place."""
    hit = _packed.get(qw)
    if hit is not None and hit[0] == qw._version:
        return hit[1], hit[2]
    wt, colsum = pack_weights(qw)
    _packed[qw] = (qw._version, wt, colsum)
    return wt, colsum


def qconv_launch(
    qa: torch.Tensor,  # [B, H, W, C] uint8, the quantized input
    sa: torch.Tensor,  # its scale, one float32
    za: torch.Tensor,  # its zero point, one float32
    wt: torch.Tensor,  # [Cout, Kp] uint8, from packed_weights
    colsum: torch.Tensor,  # [Cout] int32, from packed_weights
    scale: torch.Tensor,  # [1, Cout] weight scales
    zp: torch.Tensor,  # [1, Cout] weight zero points
    b: Optional[torch.Tensor],
    w_shape: Tuple[int, int, int, int],
    *,
    stride: int,
    pad: int,
    relu: bool,
    variant: int = -1,
    what: str = "qconv_launch",
) -> torch.Tensor:
    """Check the u8 operands and launch ``csrc/conv_fused.cu``'s
    ``qconv_u8`` on the current stream (tile variant ``variant``, -1:
    chosen from the shape): the kernel alone, with its operands ready.
    Counts no launch; :func:`qconv2d_fused` does."""
    if qa.dtype != torch.uint8 or wt.dtype != torch.uint8:
        raise TypeError(f"{what}: qa and wt must be uint8, got {qa.dtype}, {wt.dtype}")
    if qa.dim() != 4 or wt.dim() != 2:
        raise ValueError(f"{what}: want qa [B,H,W,C] and wt [Cout,Kp]")
    bsz, h, wd, c = qa.shape
    fh, fw, cw, cout = w_shape
    k = fh * fw * c
    if cw != c:
        raise ValueError(f"{what}: filter takes {cw} channels, input has {c}")
    if wt.shape[0] != cout or wt.shape[1] < k or wt.shape[1] % 16:
        raise ValueError(f"{what}: wt must be [{cout}, Kp >= {k}, Kp a multiple of 16], "
                         f"got {list(wt.shape)}")
    oh, ow = _out_size(h, wd, fh, fw, stride, pad, what)
    dev = qa.device
    if wt.device != dev:
        raise ValueError(f"{what}: wt must be on {dev}")
    if colsum.device != dev or colsum.dtype != torch.int32 or tuple(colsum.shape) != (cout,):
        raise ValueError(f"{what}: colsum must be int32 [{cout}] on {dev}")
    bias = torch.zeros(cout, device=dev) if b is None else b
    for t, name, shape in ((sa, "sa", (1,) * sa.dim()), (za, "za", (1,) * za.dim()),
                           (scale, "scale", (1, cout)), (zp, "zp", (1, cout)),
                           (bias, "bias", (cout,))):
        _check_f32(t, name, shape, dev, what)
    qa, wt, bias = qa.contiguous(), wt.contiguous(), bias.contiguous()
    scale, zp = scale.contiguous(), zp.contiguous()
    vec = int(c % 16 == 0 and qa.data_ptr() % 16 == 0)
    y = torch.empty((bsz, oh, ow, cout), device=dev, dtype=torch.float32)
    fn = R.bind("conv_fused", "qconv_u8", [R.P] * 9 + [R.I] * 15 + [R.P])
    err = fn(qa.data_ptr(), wt.data_ptr(), colsum.data_ptr(), za.data_ptr(), zp.data_ptr(),
             sa.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
             bsz, h, wd, c, fh, fw, cout, stride, pad, oh, ow, int(bool(relu)),
             wt.shape[1], vec, int(variant), R.stream(dev))
    R.check(err, "qconv_u8")
    return y


def qconv_tile_variants() -> int:
    """How many tile variants ``qconv_u8`` has (for checks that all give
    the same bits)."""
    return R.bind("conv_fused", "qconv_tile_variants", [])()


def _qconv_card(x, qw, scale, zp, b, w_shape, stride, pad, relu, variant, what):
    from ..cnn.quant import quantize_tensor

    R.require(x, "x", 4)
    fh, fw, c, cout = (int(v) for v in w_shape)
    if qw.dtype != torch.uint8:
        raise TypeError(f"{what}: qw must be uint8, got {qw.dtype}")
    if tuple(qw.shape) != (fh * fw * c, cout) or qw.device != x.device:
        raise ValueError(f"{what}: qw must be [{fh * fw * c}, {cout}] on {x.device}, got "
                         f"{list(qw.shape)} on {qw.device}")
    qa, sa, za = quantize_tensor(x, axis=None)  # per tensor, in plain PyTorch, as the reference
    wt, colsum = packed_weights(qw)
    return qconv_launch(qa, sa, za, wt, colsum, scale, zp, b, (fh, fw, c, cout), stride=stride,
                        pad=pad, relu=relu, variant=variant, what=what)


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

    The input is quantized per tensor here, in plain PyTorch, as the
    reference does outside its Pallas kernel; the filter's transposed
    copy and column sums come from :func:`packed_weights` (made once per
    weight tensor).  Then ``csrc/conv_fused.cu``'s ``qconv_u8`` sums the
    u8 products on the tensor cores, corrects them to the exact sum of
    the zero-point-shifted operands, and its epilogue applies the merged
    scale ``sa * scale[j]``, the bias and the ReLU.  A padding tap holds
    the activation zero point, so its shifted value is 0, as in the
    reference's zero-padded shifted input.  CPU tensors take
    :func:`qfused_route_ref`."""
    if not R.on_card(x, "qconv2d_fused"):
        return qfused_route_ref(
            x, qw, scale, zp, b, w_shape, stride=stride, pad=pad, relu=relu
        )
    y = _qconv_card(x, qw, scale, zp, b, w_shape, stride, pad, relu, -1, "qconv2d_fused")
    R.count("qconv2d_fused")
    return y


def qconv2d_fused_tiled(
    x: torch.Tensor,
    qw: torch.Tensor,
    scale: torch.Tensor,
    zp: torch.Tensor,
    b: Optional[torch.Tensor],
    w_shape: Tuple[int, int, int, int],
    variant: int,
    *,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """:func:`qconv2d_fused` on tile variant ``variant`` (0 ..
    :func:`qconv_tile_variants` - 1), on CUDA tensors only: for checks
    that every variant gives the same bits.  Counts no launch."""
    if not R.on_card(x, "qconv2d_fused_tiled"):
        raise ValueError("qconv2d_fused_tiled runs on the card only")
    if not 0 <= variant < qconv_tile_variants():
        raise ValueError(f"qconv2d_fused_tiled: no tile variant {variant}")
    return _qconv_card(x, qw, scale, zp, b, w_shape, stride, pad, relu, variant,
                       "qconv2d_fused_tiled")


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
    if G.order(k, n):
        R.count("matmul_fused_tc")
    return out

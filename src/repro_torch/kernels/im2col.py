"""The unfused route's patch matrix (B4), with its plain PyTorch version.

``im2col`` replaces the Pallas kernel ``repro/kernels/im2col.py::_im2col_kernel``
(entry point ``im2col``, the ARM-CL Im2Col stage, paper Fig. 10), with
the batch dimension written out: ``[B,H,W,C] -> [B*OH*OW, FH*FW*C]``,
features ordered (fh, fw, c), zeros where a tap falls in the padding.
``csrc/im2col.cu`` is a pure copy, bound by the bytes of the patch
matrix it writes, so its result is bitwise :func:`im2col_ref`'s.  It
reads ``x`` where it lies: any batch, row and pixel stride with a unit
channel stride, so a channel slice of an NHWC tensor is not copied
first.  :func:`wide_path` says which of its two paths a tensor takes.

A CPU tensor takes :func:`im2col_ref`; a CUDA tensor launches the kernel
or raises.  Each launch counts once under ``"im2col"`` in
``kernels/runtime.py``'s ``launches``.  :func:`im2col_library` computes
the same matrix in one PyTorch copy; it is a timing yardstick only.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import runtime as R


def out_hw(h: int, w: int, fh: int, fw: int, stride: int, pad: int) -> Tuple[int, int]:
    return (h - fh + 2 * pad) // stride + 1, (w - fw + 2 * pad) // stride + 1


def im2col_ref(x: torch.Tensor, fh: int, fw: int, stride: int, pad: int) -> torch.Tensor:
    """Plain version: the strided-slice stack of ``cnn/layers.im2col``,
    flattened to ``[B*OH*OW, FH*FW*C]``."""
    from ..cnn.layers import im2col as layers_im2col

    cols = layers_im2col(x, fh, fw, stride, pad)
    return cols.reshape(-1, cols.shape[-1])


def patch_view(xp: torch.Tensor, fh: int, fw: int, stride: int, oh: int, ow: int) -> torch.Tensor:
    """The padded input ``xp`` [B,Hp,Wp,C] viewed by strides as the patch
    tensor ``[B, OH, OW, FH, FW, C]`` (no copy)."""
    sb, sh, sw, sc = xp.stride()
    return xp.as_strided(
        (xp.shape[0], oh, ow, fh, fw, xp.shape[3]), (sb, stride * sh, stride * sw, sh, sw, sc)
    )


def im2col_library(x: torch.Tensor, fh: int, fw: int, stride: int, pad: int) -> torch.Tensor:
    """B4's matrix from PyTorch's own ops: ``F.pad``, then the
    :func:`patch_view` copied by ``reshape`` in one copy kernel.  Bitwise
    :func:`im2col_ref`; a timing yardstick, which nothing on the served
    path calls."""
    bsz, h, w, c = x.shape
    oh, ow = out_hw(h, w, fh, fw, stride, pad)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return patch_view(xp, fh, fw, stride, oh, ow).reshape(bsz * oh * ow, fh * fw * c)


def kernel_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """The batch, row and pixel strides (in floats) the kernel steps by;
    0 for a dimension of size 1, which it never steps along."""
    return tuple(st if n > 1 else 0 for st, n in zip(x.stride()[:3], x.shape[:3]))


def wide_path(x: torch.Tensor) -> bool:
    """True where the kernel copies with 16-byte loads and stores: C % 4 ==
    0, and the base address and the strides it steps by are multiples of
    16 bytes.  Otherwise it gathers 4-byte loads into shared memory and
    writes them out with 16-byte stores."""
    return (
        x.shape[-1] % 4 == 0
        and x.data_ptr() % 16 == 0
        and all(st % 4 == 0 for st in kernel_strides(x))
    )


def im2col(x: torch.Tensor, fh: int, fw: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """``[B,H,W,C] -> [B*OH*OW, FH*FW*C]`` f32 in one launch of
    ``csrc/im2col.cu`` on the current stream for a CUDA tensor.  ``x`` may
    be any view with a unit channel stride (a channel slice is read in
    place); another layout raises."""
    if not R.on_card(x, "im2col"):
        return im2col_ref(x, fh, fw, stride, pad)
    R.require(x, "x", 4)
    bsz, h, w, c = x.shape
    oh, ow = out_hw(h, w, fh, fw, stride, pad)
    if fh < 1 or fw < 1 or stride < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"im2col: unsupported geometry {fh}x{fw}/s{stride}/p{pad} on {h}x{w}")
    if c > 1 and x.stride(3) != 1:
        raise ValueError(f"im2col: x must be NHWC with a unit channel stride, got strides {x.stride()}")
    cols = torch.empty((bsz * oh * ow, fh * fw * c), device=x.device, dtype=torch.float32)
    fn = R.bind("im2col", "im2col_f32", [R.P] * 2 + [R.I] * 10 + [R.L] * 3 + [R.I, R.P])
    err = fn(
        x.data_ptr(), cols.data_ptr(), bsz, h, w, c, fh, fw, stride, pad, oh, ow,
        *kernel_strides(x), int(wide_path(x)), R.stream(x.device),
    )
    R.check(err, "im2col_f32")
    R.count("im2col")
    return cols

"""The unfused route's patch matrix (B4), with its plain PyTorch version.

``im2col`` replaces the Pallas kernel ``repro/kernels/im2col.py::_im2col_kernel``
(entry point ``im2col``, the ARM-CL Im2Col stage, paper Fig. 10), with
the batch dimension written out: ``[B,H,W,C] -> [B*OH*OW, FH*FW*C]``,
features ordered (fh, fw, c), zeros where a tap falls in the padding.
``csrc/im2col.cu`` is a pure copy, bound by the bytes of the patch
matrix it writes, so its result is bitwise :func:`im2col_ref`'s.

A CPU tensor takes :func:`im2col_ref`; a CUDA tensor launches the kernel
or raises.  Each launch counts once under ``"im2col"`` in
``kernels/runtime.py``'s ``launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import runtime as R


def out_hw(h: int, w: int, fh: int, fw: int, stride: int, pad: int) -> Tuple[int, int]:
    return (h - fh + 2 * pad) // stride + 1, (w - fw + 2 * pad) // stride + 1


def im2col_ref(x: torch.Tensor, fh: int, fw: int, stride: int, pad: int) -> torch.Tensor:
    """Plain version: the strided-slice stack of ``cnn/layers.im2col``,
    flattened to ``[B*OH*OW, FH*FW*C]``."""
    from ..cnn.layers import im2col as layers_im2col

    cols = layers_im2col(x, fh, fw, stride, pad)
    return cols.reshape(-1, cols.shape[-1])


def im2col(x: torch.Tensor, fh: int, fw: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """``[B,H,W,C] -> [B*OH*OW, FH*FW*C]`` f32 in one launch of
    ``csrc/im2col.cu`` on the current stream for a CUDA tensor."""
    if not R.on_card(x, "im2col"):
        return im2col_ref(x, fh, fw, stride, pad)
    R.require(x, "x", 4)
    bsz, h, w, c = x.shape
    oh, ow = out_hw(h, w, fh, fw, stride, pad)
    if fh < 1 or fw < 1 or stride < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"im2col: unsupported geometry {fh}x{fw}/s{stride}/p{pad} on {h}x{w}")
    x = x.contiguous()
    cols = torch.empty((bsz * oh * ow, fh * fw * c), device=x.device, dtype=torch.float32)
    fn = R.bind("im2col", "im2col_f32", [R.P] * 2 + [R.I] * 10 + [R.P])
    err = fn(
        x.data_ptr(), cols.data_ptr(), bsz, h, w, c, fh, fw, stride, pad, oh, ow,
        R.stream(x.device),
    )
    R.check(err, "im2col_f32")
    R.count("im2col")
    return cols

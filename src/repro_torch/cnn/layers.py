"""CNN layer primitives in plain PyTorch, NHWC activations, HWIO filters.

The counterpart of ``repro/cnn/layers.py``: convolutions run the ARM-CL
way (im2col + GEMM), so each conv's cost is the (N, K, M) GEMM of the
layer descriptor the performance model uses.  Three semantics differ
from PyTorch's defaults and are written out here:

* ``lrn`` multiplies the window sum by ``alpha`` itself (PyTorch's
  ``local_response_norm`` divides alpha by the window size);
* ``avg_pool`` divides by the count of non-padded cells
  (``count_include_pad=False``);
* ``dense`` flattens NHWC, so fc inputs are in (h, w, c) order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.config import ieee_f32_convs


def im2col(x: torch.Tensor, fh: int, fw: int, stride: int, pad: int) -> torch.Tensor:
    """[B,H,W,C] -> [B, OH*OW, FH*FW*C] patch matrix, features ordered
    (fh, fw, c) to match ``w.reshape(FH*FW*C, Cout)``."""
    b, h, w, c = x.shape
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (w - fw + 2 * pad) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    taps = [
        xp[:, i : i + stride * (oh - 1) + 1 : stride, j : j + stride * (ow - 1) + 1 : stride, :]
        for i in range(fh)
        for j in range(fw)
    ]
    patches = torch.stack(taps, dim=3)  # [B, OH, OW, FH*FW, C]
    return patches.reshape(b, oh * ow, fh * fw * c)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int = 1,
    pad: int = 0,
    groups: int = 1,
    gemm_fn=None,
) -> torch.Tensor:
    """Convolution as im2col + GEMM.  ``w``: [FH, FW, Cin/groups, Cout].

    ``gemm_fn(a, bmat)`` may be injected (a quantized closure, a kernel
    wrapper); it defaults to matmul and runs once per group."""
    gemm = gemm_fn or (lambda a, bm: a @ bm)
    bsz, h, wdt, c = x.shape
    fh, fw, cin_g, cout = w.shape
    oh = (h - fh + 2 * pad) // stride + 1
    ow = (wdt - fw + 2 * pad) // stride + 1
    if groups == 1:
        cols = im2col(x, fh, fw, stride, pad)
        out = gemm(cols.reshape(-1, cols.shape[-1]), w.reshape(fh * fw * c, cout))
        out = out.reshape(bsz, oh, ow, cout)
    else:
        outs = []
        cout_g = cout // groups
        for g in range(groups):
            cols = im2col(x[..., g * cin_g : (g + 1) * cin_g], fh, fw, stride, pad)
            wg = w[..., g * cout_g : (g + 1) * cout_g].reshape(fh * fw * cin_g, cout_g)
            outs.append(gemm(cols.reshape(-1, cols.shape[-1]), wg).reshape(bsz, oh, ow, cout_g))
        out = torch.cat(outs, dim=-1)
    if b is not None:
        out = out + b
    return out


def depthwise_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int = 1,
    pad: int = 0,
) -> torch.Tensor:
    """Depthwise conv.  ``w``: [FH, FW, 1, C].  Native grouped convolution
    (one im2col GEMM per channel would be pathological), in IEEE f32 on
    the card (``kernels/config.py::ieee_f32_convs``)."""
    if x.is_cuda:
        ieee_f32_convs()
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
        stride=stride, padding=pad, groups=x.shape[-1],
    ).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out


def dense(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], gemm_fn=None
) -> torch.Tensor:
    gemm = gemm_fn or (lambda a, bm: a @ bm)
    out = gemm(x.reshape(x.shape[0], -1), w)
    return out + b if b is not None else out


def max_pool(x: torch.Tensor, window: int, stride: int, pad: int = 0) -> torch.Tensor:
    """-inf padding, floored output size."""
    return F.max_pool2d(
        x.permute(0, 3, 1, 2), window, stride, padding=pad
    ).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int, stride: int, pad: int = 0) -> torch.Tensor:
    """Mean over the window's non-padded cells."""
    return F.avg_pool2d(
        x.permute(0, 3, 1, 2), window, stride, padding=pad, count_include_pad=False
    ).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


def lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4, beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """AlexNet local response normalization (cross-channel), alpha NOT
    divided by ``size``."""
    sq = x * x
    half = size // 2
    sq_p = F.pad(sq, (half, half))
    acc = sum(sq_p[..., i : i + x.shape[-1]] for i in range(size))
    return x / torch.pow(k + alpha * acc, beta)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)

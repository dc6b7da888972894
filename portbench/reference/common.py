"""What the references share: the weighted-layer record, the conv and fc
equations, and the arithmetic precision they run in.

Activations run NCHW inside a reference (the images arrive NHWC, as the
program takes them); filters are stored HWIO and fc weights [in, out],
the layout the program takes, so one set of tensors serves both sides.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Layer:
    """One weighted layer: a conv (``k`` x ``k``, HWIO filter) or an fc
    (``k`` = 1, ``h`` = ``w`` = 1, ``cin`` the flattened features)."""

    name: str
    kind: str  # "conv" | "fc"
    k: int
    cin: int
    cout: int
    stride: int
    pad: int
    h: int  # input height
    w: int  # input width

    @property
    def oh(self) -> int:
        return (self.h - self.k + 2 * self.pad) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w - self.k + 2 * self.pad) // self.stride + 1

    @property
    def w_shape(self):
        if self.kind == "fc":
            return (self.cin, self.cout)
        return (self.k, self.k, self.cin, self.cout)

    @property
    def fan_in(self) -> int:
        return self.k * self.k * self.cin


def same(t: torch.Tensor) -> torch.Tensor:
    return t


def conv(h: torch.Tensor, p, stride: int, pad: int, relu: bool, cast=same) -> torch.Tensor:
    """Cross-correlation plus bias (NCHW), then an optional ReLU; ``cast``
    maps both operands of the product (see :func:`round_tf32`)."""
    w = cast(p["w"]).permute(3, 2, 0, 1)
    y = F.conv2d(cast(h), w, p["b"], stride=stride, padding=pad)
    return torch.relu(y) if relu else y


def fc(h: torch.Tensor, p, relu: bool, cast=same) -> torch.Tensor:
    y = cast(h) @ cast(p["w"]) + p["b"]
    return torch.relu(y) if relu else y


def nhwc_flatten(h: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW map in (h, w, c) order, as the served graph does."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), kept in f32: the operands a TF32 tensor core multiplies.
    Passed as ``cast`` it computes the control where the device has no
    TF32 (the CPU)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision(mode: str) -> Iterator[None]:
    """``"f32"``: IEEE f32 on every route (TF32 off for cuBLAS and cuDNN),
    the configuration's precision.  ``"tf32"``: TF32 on for both, the
    precision below it (the control).  The flags are restored after."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


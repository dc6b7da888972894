"""Layer descriptors and conv-as-GEMM dimension math (paper Eq. 3-4).

A ``ConvDescriptor`` captures the statically-available network structure
descriptors the paper's performance model consumes: input tensor size,
filter size, padding and stride.  ``gemm_dims`` converts a convolution to
the (N, K, M) dimensions of its im2col GEMM realisation:

    N = Ow * Oh          (rows of the image matrix: one row per patch)
    K = Fw * Fh * Fd     (patch volume)
    M = Ofm              (number of filters / output feature maps)

Fully-connected layers are GEMMs with N = 1 (per image), K = in_features,
M = out_features.  Depthwise convolutions are modelled per the ARM-CL
implementation as Fd = 1 with channel-wise grouping folded into N.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GemmDims:
    """Dimensions of an im2col-realised GEMM: image [N,K] x filter [K,M]."""

    N: int
    K: int
    M: int

    @property
    def macs(self) -> int:
        """Total multiply-accumulates (paper: 'arithmetic operations')."""
        return self.N * self.K * self.M

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def bytes_touched(self, dtype_bytes: int = 4) -> int:
        """Matrix footprint NK + KM + NM (paper Eq. 5 interaction terms)."""
        return dtype_bytes * (self.N * self.K + self.K * self.M + self.N * self.M)


@dataclasses.dataclass(frozen=True)
class ConvDescriptor:
    """Statically-available descriptor of a convolutional layer (Fig. 10).

    Dimensions follow the paper's notation: input image tensor
    {I_w, I_h, I_d}, filter {F_w, F_h, F_d, Ofm}, padding ``pad`` and
    stride ``s``.
    """

    name: str
    i_w: int
    i_h: int
    i_d: int
    f_w: int
    f_h: int
    ofm: int
    pad: int = 0
    stride: int = 1
    groups: int = 1  # groups == i_d -> depthwise
    kind: str = "conv"  # conv | depthwise | fc

    @property
    def f_d(self) -> int:
        # Input tensor and filter must have matching depth (paper: I_d = F_d),
        # divided across groups for grouped/depthwise convolution.
        return self.i_d // self.groups

    def output_shape(self) -> Tuple[int, int, int]:
        """Paper Eq. 3."""
        o_w = (self.i_w - self.f_w + 2 * self.pad) // self.stride + 1
        o_h = (self.i_h - self.f_h + 2 * self.pad) // self.stride + 1
        return o_w, o_h, self.ofm

    def gemm_dims(self) -> GemmDims:
        """Paper Eq. 4 (extended with grouping for depthwise layers)."""
        o_w, o_h, o_d = self.output_shape()
        if self.kind == "fc":
            return GemmDims(N=1, K=self.i_w * self.i_h * self.i_d, M=self.ofm)
        n = o_w * o_h
        k = self.f_w * self.f_h * self.f_d
        m = self.ofm // self.groups
        # Grouped conv executes `groups` independent GEMMs; ARM-CL folds the
        # group loop into the row dimension of the image matrix.
        return GemmDims(N=n * self.groups, K=k, M=m)

    @property
    def weight_count(self) -> int:
        if self.kind == "fc":
            return self.i_w * self.i_h * self.i_d * self.ofm + self.ofm
        return self.f_w * self.f_h * self.f_d * self.ofm + self.ofm

    @property
    def activation_out_elems(self) -> int:
        o_w, o_h, o_d = self.output_shape()
        return o_w * o_h * o_d


def fc_descriptor(name: str, in_features: int, out_features: int) -> ConvDescriptor:
    """A fully-connected layer as a degenerate conv descriptor."""
    return ConvDescriptor(
        name=name, i_w=1, i_h=1, i_d=in_features, f_w=1, f_h=1,
        ofm=out_features, pad=0, stride=1, kind="fc",
    )


def conv_descriptor(
    name: str,
    in_hw: int,
    in_ch: int,
    kernel: int,
    out_ch: int,
    stride: int = 1,
    pad: Optional[int] = None,
    depthwise: bool = False,
) -> ConvDescriptor:
    """Convenience constructor for square convolutions (paper assumption
    I_w == I_h, O_w == O_h)."""
    if pad is None:
        pad = kernel // 2  # 'same' for stride 1
    return ConvDescriptor(
        name=name, i_w=in_hw, i_h=in_hw, i_d=in_ch, f_w=kernel, f_h=kernel,
        ofm=out_ch, pad=pad, stride=stride,
        groups=in_ch if depthwise else 1,
        kind="depthwise" if depthwise else "conv",
    )

"""The yardstick: the card's peaks and each weighted layer's operations
and bytes, from its published shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s on the bf16 tensor cores, 67 TFLOP/s in f32 outside
them, 3.35 TB/s of HBM.  Roofline shares are taken against the bf16
tensor-core rate, so one count reads the same work whatever units an
implementation runs it on; the f32 CUDA-core share is printed beside it
for reading.  Bytes count each input, weight, bias and output once, in
f32.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12
DTYPE_BYTES = 4


def macs(layer, batch: int = 1) -> int:
    """Multiply-adds of one conv or fc layer over ``batch`` images."""
    return batch * layer.oh * layer.ow * layer.k * layer.k * layer.cin * layer.cout


def flops(layer, batch: int = 1) -> int:
    return 2 * macs(layer, batch)


def nbytes(layer, batch: int = 1) -> int:
    """Input, weights, bias and output, each once."""
    elems = (
        batch * layer.h * layer.w * layer.cin
        + layer.k * layer.k * layer.cin * layer.cout
        + layer.cout
        + batch * layer.oh * layer.ow * layer.cout
    )
    return DTYPE_BYTES * elems


def bound_s(layer, batch: int, peak_flops: float = PEAK_FLOPS) -> float:
    """The least time the card could take for the layer: the larger of
    its operations over the compute peak and its bytes over HBM's."""
    return max(flops(layer, batch) / peak_flops, nbytes(layer, batch) / PEAK_BYTES)


def totals(layers: Iterable, batch: int, peak_flops: float = PEAK_FLOPS) -> Tuple[int, float]:
    """(FLOPs, summed roofline bound in seconds) of one micro-batch."""
    layers = list(layers)
    return (
        sum(flops(l, batch) for l in layers),
        sum(bound_s(l, batch, peak_flops) for l in layers),
    )

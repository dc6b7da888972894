"""Entry points of the unfused conv-as-GEMM kernels, mirroring
``repro/kernels/ops.py``.

Routing is by the tensor's device alone, as for ``conv2d_fused``: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (``csrc/gemm.cu``, ``csrc/im2col.cu``) or raises.
There is no backend argument: the reference's ``"jnp"`` and
``"interpret"`` choices have no counterpart on the card.
"""
from __future__ import annotations

import torch

from .gemm import gemm
from .im2col import im2col as im2col_batched

__all__ = ["gemm", "im2col", "im2col_batched"]


def im2col(x: torch.Tensor, fh: int, fw: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """``[H,W,C] -> [OH*OW, FH*FW*C]``, the reference's signature; the
    ``"cuda"`` route calls :func:`im2col_batched` (``[B,H,W,C] ->
    [B*OH*OW, FH*FW*C]``) instead."""
    return im2col_batched(x[None], fh, fw, stride, pad)

"""The unfused route's GEMM (B3), with its plain PyTorch version.

``gemm`` replaces the Pallas kernel ``repro/kernels/gemm.py::_gemm_kernel``
(entry point ``gemm``): ``[M,K] @ [K,N]`` with f32 accumulation, the GEMM
under the conv-as-GEMM route of paper section V-A (``"pallas"`` in the
reference, ``"cuda"`` here).  ``csrc/gemm.cu`` accumulates in IEEE f32 on
the CUDA cores (no TF32), so it holds the reference's tolerance; the
conv GEMMs are bound by operations, the fc GEMMs at the serving
micro-batch by the bytes of the weights.  Each output is summed in an
order fixed by (K, N) alone, so a row's result does not depend on M,
the batch it rides in.

A CPU tensor takes :func:`gemm_ref`; a CUDA tensor launches the kernel
or raises.  Each launch counts once under ``"gemm"`` in
``kernels/runtime.py``'s ``launches``.
"""
from __future__ import annotations

import functools

import torch

from . import runtime as R


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``a @ b`` in f32 (with TF32 off on the card)."""
    return a @ b


@functools.lru_cache(maxsize=None)
def _slice_len(k: int, n: int) -> int:
    return R.bind("gemm", "gemm_slice_len", [R.I, R.I])(k, n)


@functools.lru_cache(maxsize=None)
def _skinny_max_m() -> int:
    return R.bind("gemm", "gemm_skinny_max_m", [])()


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N] -> [M,N]`` f32; launches ``csrc/gemm.cu`` on the
    current stream for CUDA tensors."""
    if not R.on_card(a, "gemm"):
        return gemm_ref(a, b)
    R.require(a, "a", 2)
    R.require(b, "b", 2)
    m, k = a.shape
    kb, n = b.shape
    if kb != k:
        raise ValueError(f"gemm: inner dims differ ({k} vs {kb})")
    dev = a.device
    if b.device != dev:
        raise ValueError(f"gemm: b must be on {dev}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    part = None
    if 0 < m <= _skinny_max_m() and k > 0:
        slices = -(-k // _slice_len(k, n))
        part = torch.empty((slices, m, n), device=dev, dtype=torch.float32)
    fn = R.bind("gemm", "gemm_f32", [R.P] * 4 + [R.I] * 3 + [R.P])
    err = fn(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, k, n, R.stream(dev),
    )
    R.check(err, "gemm_f32")
    R.count("gemm")
    return out

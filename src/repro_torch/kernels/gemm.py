"""The unfused route's GEMM (B3), with its plain PyTorch version.

``gemm`` replaces the Pallas kernel ``repro/kernels/gemm.py::_gemm_kernel``
(entry point ``gemm``): ``[M,K] @ [K,N]`` with f32 accumulation, the GEMM
under the conv-as-GEMM route of paper section V-A (``"pallas"`` in the
reference, ``"cuda"`` here).  ``csrc/gemm.cu`` keeps f32 accuracy, so it
holds the reference's tolerance: where K is a multiple of 16 and at
least 64 (:func:`order` 1) the products run on the TF32 tensor cores
with each operand split into two TF32 terms (:func:`split_tf32_ref`),
three term products kept and each 32-deep step's sum folded into the f32
total on the CUDA cores; elsewhere (order 0) in IEEE ``fmaf`` on the CUDA
cores.  The conv GEMMs are bound by operations, the fc GEMMs at the
serving micro-batch by the bytes of the weights.  M > 8 takes a tiled
kernel (a ``cp.async`` ring of shared-memory stages; the tile variant is
chosen from (M, K, N)), M <= 8 a split-K kernel and a fixed second pass.
Each output is summed in an order fixed by (K, N) alone, so a row's
result does not depend on M, the batch it rides in, nor on the tile
variant: :func:`gemm_tiled` runs a chosen variant, so that checks can
hold every variant to the same bits.  The fused conv and fc GEMM
(``kernels/conv_fused.py``) run the same kernels with an implicit A
loader and a bias/ReLU epilogue, in the same order, so their outputs are
this GEMM's followed by ``+ bias``.

A CPU tensor takes :func:`gemm_ref`; a CUDA tensor launches the kernel
or raises.  Each launch counts once under ``"gemm"`` in
``kernels/runtime.py``'s ``launches``, and once more under ``"gemm_tc"``
where it sums in order 1.
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
def order(k: int, n: int) -> int:
    """The order ``csrc/gemm.cu`` sums a ``[*, k] @ [k, n]`` product in: 1
    on the tensor cores, 0 on the CUDA cores (its ``gemm_order``, the one
    statement of the rule)."""
    return R.bind("gemm", "gemm_order", [R.I, R.I])(k, n)


TF32_DROPPED_BITS = 13  # of an f32 significand's 23 stored bits, TF32 keeps 10


def tf32_round_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cvt.rna.tf32.f32`` on finite f32 values: each
    rounded to 10 stored significand bits, to nearest with ties away from
    zero (the magnitude's bit pattern plus half the dropped unit, then the
    dropped bits cleared; the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    half, keep = 1 << (TF32_DROPPED_BITS - 1), -(1 << TF32_DROPPED_BITS)
    return ((bits + half) & keep).view(torch.float32)


def split_tf32_ref(x: torch.Tensor):
    """Plain version of ``csrc/gemm.cu``'s ``split_tf32``: ``hi = tf32(x)``,
    ``lo = tf32(x - hi)``; ``x - hi`` is exact in f32, so ``x - hi - lo``
    is at most ``2^-22 |x|``.  The kernels multiply ``lo(a) hi(b) + hi(a)
    lo(b) + hi(a) hi(b)`` for ``a b``."""
    hi = tf32_round_ref(x)
    return hi, tf32_round_ref(x - hi)


def split_tf32(x: torch.Tensor):
    """:func:`split_tf32_ref` computed by the kernels' own device function,
    on a CUDA tensor only: for checks that the two agree bitwise."""
    if not R.on_card(x, "split_tf32"):
        raise ValueError("split_tf32 runs on the card only")
    R.require(x, "x", x.dim())
    x = x.contiguous()
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    fn = R.bind("gemm", "gemm_split_tf32", [R.P] * 3 + [R.I, R.P])
    R.check(fn(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(), R.stream(x.device)), "gemm_split_tf32")
    return hi, lo


@functools.lru_cache(maxsize=None)
def _skinny_max_m() -> int:
    return R.bind("gemm", "gemm_skinny_max_m", [])()


@functools.lru_cache(maxsize=None)
def tile_variants() -> int:
    """How many tile variants the tiled kernel has."""
    return R.bind("gemm", "gemm_tile_variants", [])()


def partials(m: int, k: int, n: int, device: torch.device):
    """Scratch of the skinny path (M <= 8): one [M, N] partial per K slice
    of ``gemm_slice_len(K, N)`` rows; ``None`` where the tiled path runs
    or K is 0.  Shared with the fused fc GEMM, which takes the same path."""
    if not (0 < m <= _skinny_max_m() and k > 0):
        return None
    slices = -(-k // _slice_len(k, n))
    return torch.empty((slices, m, n), device=device, dtype=torch.float32)


def _operands(a: torch.Tensor, b: torch.Tensor):
    R.require(a, "a", 2)
    R.require(b, "b", 2)
    if b.shape[0] != a.shape[1]:
        raise ValueError(f"gemm: inner dims differ ({a.shape[1]} vs {b.shape[0]})")
    if b.device != a.device:
        raise ValueError(f"gemm: b must be on {a.device}")
    return a.contiguous(), b.contiguous()


def gemm_tiled(a: torch.Tensor, b: torch.Tensor, variant: int) -> torch.Tensor:
    """``a @ b`` through the tiled kernel's tile variant ``variant`` (0 ..
    ``tile_variants() - 1``) at any M, on CUDA tensors only: for checks
    that every variant, and the skinny path, give the same bits.  Counts
    no launch (the main path never calls it)."""
    if not R.on_card(a, "gemm_tiled"):
        raise ValueError("gemm_tiled runs on the card only")
    a, b = _operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    fn = R.bind("gemm", "gemm_f32_tiled", [R.P] * 3 + [R.I] * 4 + [R.P])
    R.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, int(variant),
               R.stream(a.device)), "gemm_f32_tiled")
    return out


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M,K] @ [K,N] -> [M,N]`` f32; launches ``csrc/gemm.cu`` on the
    current stream for CUDA tensors."""
    if not R.on_card(a, "gemm"):
        return gemm_ref(a, b)
    a, b = _operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    part = partials(m, k, n, dev)
    fn = R.bind("gemm", "gemm_f32", [R.P] * 4 + [R.I] * 3 + [R.P])
    err = fn(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, k, n, R.stream(dev),
    )
    R.check(err, "gemm_f32")
    R.count("gemm")
    if order(k, n):
        R.count("gemm_tc")
    return out

"""Decode attention over a KV cache (B5), with its plain PyTorch version.

``flash_decode`` replaces the Pallas kernel
``repro/kernels/flash_decode.py::_flash_decode_kernel``: one new query
token attends to the valid prefix of a cache with an online softmax,
scale ``1/sqrt(D)``, operands read as f32, output ``acc / max(l, 1e-30)``
in q's type.  The TPU kernel handles one KV head and is vmapped over
(batch, KV head); this one takes the batched, GQA-grouped form the model
holds: q ``[B, Hkv, G, D]`` (a view of ``[B, H, D]``), caches
``[B, W, Hkv, D]`` as ``models/blocks.py::_ring_write`` leaves them, and
one ``length``.  ``csrc/flash_decode.cu`` cuts the cache into
splits of :func:`split_len` slots (a function of W and D alone), runs one
block per (split, KV head, batch) that leaves a partial softmax state in
f32 scratch, and adds the partials in split order in a second pass: two
kernels behind one C call and one count, one call per layer per decode
step.  Since the split length does not depend on the batch or on
``length``, a row's output is bitwise the same at any batch size.

**``length`` on the host or on the device.**  An int is checked on the
host (``1 <= length <= W``) and passed by value.  A one-element int32
tensor on the card is passed by address, and both passes read it there,
clamped to ``[1, W]``: the grid and the scratch stay fixed by ``W`` and
``D``, so a decode step captured as a CUDA graph (``kernels/graphs.py``)
attends over the prefix of the position it is replayed at, as the
reference's kernel reads its ``len_ref`` from a device array.  The two
forms give the same bits at the same length.  The plain version takes
the tensor form by masking the slots past it instead of slicing them
off, so that it reads no device value on the host either.

**A prefix stands for the reference's position mask.**
``repro.models.attention.decode_attention`` masks each slot by the
position it holds: ``pos >= 0``, ``pos < length`` and, on a window layer,
``pos >= length - window``.  This kernel masks a prefix of slots.  Called
with ``min(length, W)``, where ``W`` is the layer's cache size
(``models/model.py::init_cache``), the two select the same keys:

- a full-attention layer has ``W = max_len >= length`` and slot ``i``
  holds position ``i``, so the valid slots are ``[0, length)``;
- a window layer has ``W = min(max_len, window)``.  Before the ring
  wraps, slot ``i`` holds position ``i`` and the first ``length`` slots
  are valid (all of them inside the window, since ``length <= W <=
  window``).  Once it has wrapped, the W slots hold positions ``length -
  W .. length - 1`` (the port's ``_ring_write`` keeps the last W positions
  of a long prefill), all of which are ``>= length - window``: every slot
  is valid, and ``min(length, W) = W``.

Which slot holds which position does not matter to the softmax, so the
prefix is exact.  ``tests/test_torch_flash_decode.py`` holds this against
``decode_attention`` with positions on a wrapped ring buffer.

The plain version keeps the softmax weights in f32 for the PV product, as
the TPU kernel does; ``decode_attention`` casts them to the cache's type
first, so in bf16 the two differ by about one bf16 rounding of the
weights.

**An int8 cache.**  With ``k_scale`` and ``v_scale`` (``[B, W, Hkv]``
f32, one per slot and head, as ``models/blocks.py::_quantize_kv`` leaves
them) k and v are int8.  The plain version dequantizes them into q's type
as the reference's decode does (``repro/models/blocks.py``: ``k.astype(
q.dtype) * k_scale[..., None].astype(q.dtype)``) and attends over that;
the kernel dequantizes each value it reads in the same arithmetic, so it
gives the same bits as itself on the cache :func:`dequantize` returns.

A CPU tensor takes :func:`flash_decode_ref`; a CUDA tensor launches the
kernel or raises.  Each launch counts once under ``"flash_decode"`` in
``kernels/runtime.py``'s ``launches``.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from . import runtime as R

DTYPES = (torch.float32, torch.bfloat16)
Length = Union[int, torch.Tensor]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: Length,
           k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None) -> Length:
    """The shapes, the scales of an int8 cache, and ``length``: an int in
    ``[1, W]``, or a one-element int32 tensor on q's device (returned as
    it is: its value is never read on the host)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_decode: want q [B,Hkv,G,D] and k/v [B,W,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hkv, _, d = q.shape
    if k.shape[0] != b or k.shape[2] != hkv or k.shape[3] != d:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    quant = k.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or (k_scale is not None) != quant or v.dtype != k.dtype:
        raise TypeError(
            f"flash_decode: an int8 cache takes k_scale and v_scale, another none; got k {k.dtype}, "
            f"v {v.dtype}, scales {None if k_scale is None else k_scale.dtype}, "
            f"{None if v_scale is None else v_scale.dtype}"
        )
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.dtype != torch.float32 or tuple(sc.shape) != tuple(k.shape[:3]) or sc.device != k.device:
                raise ValueError(
                    f"flash_decode: {name} must be float32 {tuple(k.shape[:3])} on {k.device}, got "
                    f"{sc.dtype} {tuple(sc.shape)} on {sc.device}"
                )
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int32 or length.numel() != 1 or length.device != q.device:
            raise ValueError(
                f"flash_decode: a tensor length must be one int32 on {q.device}, got "
                f"{length.dtype} of shape {tuple(length.shape)} on {length.device}"
            )
        return length
    length = int(length)
    if not 1 <= length <= k.shape[1]:
        raise ValueError(f"flash_decode: length {length} outside [1, {k.shape[1]}]")
    return length


def dequantize(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int8 cache ``[..., D]`` with its scales ``[...]`` in ``dtype``,
    as the reference's decode dequantizes it: both cast to ``dtype``, then
    multiplied there (in bf16, each product rounded to bf16)."""
    return x.to(dtype) * scale[..., None].to(dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: Length,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``softmax(q k^T / sqrt(D)) v`` over slots
    ``[0, length)``, in f32, cast to q's type.  q ``[B,Hkv,G,D]``, k/v
    ``[B,W,Hkv,D]`` -> ``[B,Hkv,G,D]``; an int8 k/v with its scales
    ``[B,W,Hkv]`` is first dequantized into q's type (:func:`dequantize`).
    A tensor ``length`` (clamped to ``[1, W]``, as the kernel does) masks
    the slots past it; an int slices them off."""
    length = _check(q, k, v, length, k_scale, v_scale)
    if k_scale is not None:
        k, v = dequantize(k, k_scale, q.dtype), dequantize(v, v_scale, q.dtype)
    scale = 1.0 / q.shape[-1] ** 0.5
    masked = isinstance(length, torch.Tensor)
    kf = (k if masked else k[:, :length]).float()
    vf = (v if masked else v[:, :length]).float()
    logits = torch.einsum("bkgd,bskd->bkgs", q.float(), kf) * scale
    if masked:  # the masked slots weigh exp(-inf) = 0
        slots = torch.arange(k.shape[1], device=k.device)
        valid = slots < length.reshape(()).clamp(1, k.shape[1])
        logits = logits.masked_fill(~valid, float("-inf"))
        vf = vf.masked_fill(~valid[:, None, None], 0.0)  # 0 * stale inf would be nan
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def split_len(w: int, d: int) -> int:
    """Cache slots per split of the kernel's first pass at cache size
    ``w`` and head dim ``d`` (``flash_decode_split_len``)."""
    return R.bind("flash_decode", "flash_decode_split_len", [R.I, R.I])(w, d)


@functools.lru_cache(maxsize=None)
def _limits():
    max_gd = R.bind("flash_decode", "flash_decode_max_gd", [])()
    max_d = R.bind("flash_decode", "flash_decode_max_d", [])()
    return max_gd, max_d


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: Length,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over the first ``length`` cache slots (an int, or
    an int32 tensor on the card read there), of a cache in q's type or an
    int8 one with its scales; launches ``csrc/flash_decode.cu`` on the
    current stream for CUDA tensors."""
    if not R.on_card(q, "flash_decode"):
        return flash_decode_ref(q, k, v, length, k_scale, v_scale)
    R.require(q, "q", 4, DTYPES)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash_decode: k and v must be on {dev}")
    length = _check(q, k, v, length, k_scale, v_scale)
    quant = k_scale is not None
    if not quant and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise TypeError(f"flash_decode: q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hkv, g, d = q.shape
    max_gd, max_d = _limits()
    vec = 16 // q.element_size()
    if d % vec or d > max_d or g * d > max_gd:
        raise ValueError(
            f"flash_decode: head_dim {d} must be a multiple of {vec} and <= {max_d}, "
            f"and G*D = {g * d} <= {max_gd}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    piece = vec * k.element_size()  # the bytes of a lane's copy: 16, or 8 / 4 of int8
    if q.data_ptr() % 16 or k.data_ptr() % piece or v.data_ptr() % piece:
        raise ValueError(f"flash_decode: q must be 16-byte aligned, k and v {piece}-byte aligned")
    if quant:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    w = k.shape[1]
    out = torch.empty_like(q)
    n_split = -(-w // split_len(w, d))
    part = torch.empty(b * hkv * n_split * g * (d + 2), device=dev, dtype=torch.float32)
    on_device = isinstance(length, torch.Tensor)
    fn = R.bind("flash_decode", "flash_decode_fwd", [R.P] * 8 + [R.I] * 7 + [R.F, R.P])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
        length.data_ptr() if on_device else None,
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        int(q.dtype == torch.bfloat16), b, hkv, g, d, w, 0 if on_device else length,
        1.0 / d ** 0.5, R.stream(dev),
    )
    R.check(err, "flash_decode_fwd")
    R.count("flash_decode")
    return out

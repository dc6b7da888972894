"""Entry points of the hand-written kernels outside the fused conv route,
mirroring ``repro/kernels/ops.py``.

Routing of ``gemm`` and ``im2col`` is by the tensor's device alone, as
for ``conv2d_fused``: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the hand-written kernel (``csrc/gemm.cu``,
``csrc/im2col.cu``) or raises.

``flash_decode`` and ``ssd`` take a ``backend``: ``None`` launches the
kernel (``csrc/flash_decode.cu``, ``csrc/ssd.cu``) for a CUDA tensor and
takes the plain version for a CPU tensor; ``"torch"`` asks for the plain
version on any device, which only the tests and ``chip_smoke.py`` do, to
hold the kernels' path against the plain one on the card, and the train
step, since the kernels have no backward.  Asked to launch a kernel
while autograd records (gradients enabled and an input that requires
one), either raises rather than return an output with no gradient or
quietly take the plain version.  The reference's ``"jnp"`` and
``"interpret"`` choices have no counterpart here.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) ``backend=None``
launches nothing and runs no op: it returns empty outputs of the
kernel's shapes and dtypes and, while ``roofline/analysis.py`` traces a
step, records one call of the kernel with its FLOPs and bytes
(``flash_decode_cost``, ``ssd_cost``).  B5's length on the device is not
read there, so it counts every cache slot.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..roofline.analysis import flash_decode_cost, note_kernel_call, ssd_cost
from . import flash_decode as FD
from . import ssd as SSD
from .gemm import gemm
from .im2col import im2col as im2col_batched

__all__ = ["gemm", "im2col", "im2col_batched", "flash_decode", "ssd", "BACKENDS"]

BACKENDS = (None, "torch")


def im2col(x: torch.Tensor, fh: int, fw: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """``[H,W,C] -> [OH*OW, FH*FW*C]``, the reference's signature; the
    ``"cuda"`` route calls :func:`im2col_batched` (``[B,H,W,C] ->
    [B*OH*OW, FH*FW*C]``) instead."""
    return im2col_batched(x[None], fh, fw, stride, pad)


def _check_backend(backend: Optional[str]) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _no_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where the kernel route of ``name`` would run under autograd:
    a CUDA input, gradients enabled and an input that requires one."""
    if (torch.is_grad_enabled() and tensors[0].is_cuda
            and any(t is not None and t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; a differentiable call "
            "takes the plain version with backend='torch'"
        )


def flash_decode(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: FD.Length,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention of q ``[B,Hkv,G,D]`` over cache slots ``[0,
    length)`` of k/v ``[B,W,Hkv,D]`` -> ``[B,Hkv,G,D]``; ``length`` is an
    int or an int32 tensor on q's device.  An int8 k/v comes with its f32
    scales ``k_scale``/``v_scale`` ``[B,W,Hkv]``.  The reference's
    single-head call ``flash_decode(q [G,D], k [S,D], v, length)`` is
    ``flash_decode(q[None, None], k[None, :, None], v[None, :, None],
    length)[0, 0]`` here."""
    _check_backend(backend)
    if backend == "torch":
        return FD.flash_decode_ref(q, k, v, length, k_scale, v_scale)
    _no_autograd("flash_decode", q, k, v, k_scale, v_scale)
    if q.device.type == "meta":
        length = FD._check(q, k, v, length, k_scale, v_scale)
        b, hkv, g, d = q.shape
        slots = k.shape[1] if isinstance(length, torch.Tensor) else length
        note_kernel_call("flash_decode", *flash_decode_cost(
            b, hkv, g, d, slots, q.element_size(), k.element_size(), quant=k_scale is not None))
        return torch.empty_like(q)
    return FD.flash_decode(q, k, v, length, k_scale, v_scale)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (S) by ``pad``, keeping a broadcast (stride-0) head
    dim broadcast instead of materialising it."""
    if t.dim() == 4 and t.stride(2) == 0 and t.shape[2] > 1:
        return F.pad(t[:, :, :1], (0, 0, 0, 0, 0, pad)).expand(-1, -1, t.shape[2], -1)
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd(
    x: torch.Tensor,
    log_a: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    chunk: int = 128,
    backend: Optional[str] = None,
    normalizer: bool = False,
    n0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Chunked selective scan, batched: x ``[B,S,H,P]``, log_a ``[B,S,H]``,
    B/C ``[B,S,H,N]`` (a head stride of 0 is kept), h0 ``[B,H,N,P]`` or
    ``None`` for zeros -> (y ``[B,S,H,P]``, h_final ``[B,H,N,P]`` f32);
    with ``normalizer=True`` also (den ``[B,S,H]`` f32, n_final
    ``[B,H,N]`` f32) from n0 ``[B,H,N]`` or zeros, as the reference's
    ``ssd_scan``.  The reference's single-sequence ``ssd`` vmaps over the
    batch instead.

    A ragged S is padded to a chunk multiple with ``log_a = 0`` (a = 1)
    and ``B = 0`` (no input), which leaves y, den and both states exact,
    and y and den are sliced back, as ``ssd_scan`` does."""
    _check_backend(backend)
    if backend is None:
        _no_autograd("ssd", x, log_a, B, C, h0, n0)
    s = x.shape[1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x, log_a, B, C = (_pad_seq(t, pad) for t in (x, log_a, B, C))
    if backend is None and x.device.type == "meta":
        out = _ssd_on_meta(x, log_a, B, C, h0, q, normalizer, n0)
    else:
        run = SSD.ssd if backend is None else SSD.ssd_ref
        out = run(x, log_a, B, C, h0=h0, chunk=q, normalizer=normalizer, n0=n0)
    if not pad:
        return out
    if normalizer:
        y, h_final, den, n_final = out
        return y[:, :s], h_final, den[:, :s], n_final
    return out[0][:, :s], out[1]


def _ssd_on_meta(x, log_a, B, C, h0, chunk, normalizer, n0) -> Tuple[torch.Tensor, ...]:
    """B6's call on ``meta`` tensors (S already a chunk multiple): its
    cost noted, its outputs empty."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    note_kernel_call("ssd", *ssd_cost(
        b, s, h, n, p, chunk, normalizer, bc_heads=1 if B.stride(2) == 0 else h,
        x_bytes=x.element_size(), la_bytes=log_a.element_size(), h0=h0 is not None, n0=n0 is not None))
    f32 = dict(dtype=torch.float32, device=x.device)
    y, h_final = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device), torch.empty((b, h, n, p), **f32)
    if not normalizer:
        return y, h_final
    return y, h_final, torch.empty((b, s, h), **f32), torch.empty((b, h, n), **f32)

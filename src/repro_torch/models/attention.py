"""Attention: GQA + RoPE, the forward of the blockwise (flash-style)
prefill path, and the reference's position-masked decode attention.

Port of ``repro/models/attention.py``.  The prefill path never holds the
``[S, S]`` logits: an outer loop over query chunks and an inner
online-softmax loop over key chunks keep the live block at ``[B, Hkv, G,
cq, ck]``, with masks (causal, sliding window, prefix-LM) made per block
from positions.  It is plain PyTorch (the reference's ``_flash`` is jnp,
not Pallas) and forward only: the port has no train path.  Logits and
the PV product are taken on f32 operands, the counterpart of the
reference's ``preferred_element_type=jnp.float32``.

``decode_attention`` stays as the reference wrote it, for the tests: the
model's decode path calls the B5 kernel through ``kernels/ops.py::
flash_decode`` instead (see ``kernels/flash_decode.py`` for why a prefix
of slots selects the same keys as this function's position mask).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, dh], positions: [B, S] or [S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angle = positions[..., None].float() * freq  # [B, S, half]
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int, prefix: int) -> torch.Tensor:
    """[cq, ck] boolean mask from absolute positions.

    window: 0 -> unlimited causal; >0 -> sliding window of that size.
    prefix: 0 -> none; >0 -> positions < prefix attend bidirectionally.
    Negative positions are padding.
    """
    q = qpos[:, None]
    k = kpos[None, :]
    allowed = k <= q
    if window > 0:
        allowed &= (q - k) < window
    allowed |= (q < prefix) & (k < prefix)
    allowed &= (k >= 0) & (q >= 0)
    return allowed


def _mask_penalty(qpos: torch.Tensor, kpos: torch.Tensor, window: int, prefix: int) -> torch.Tensor:
    """Additive f32 [cq, ck] mask (0 allowed / -1e30 banned)."""
    allowed = _block_mask(qpos, kpos, window, prefix)
    return torch.where(allowed, 0.0, _NEG).to(torch.float32)


def _flash_fwd(q, k, v, qp, kp, window: int, prefix: int) -> torch.Tensor:
    """q [B, nq, cq, Hkv, G, dh], k/v [B, nk, ck, Hkv, dh], positions
    [nq, cq] / [nk, ck] -> out [nq, B, Hkv, G, cq, dh] in q's type."""
    b, nq, cq, hkv, g, dh = q.shape
    nk = k.shape[1]
    scale = dh ** -0.5
    outs = []
    for i in range(nq):
        qi = q[:, i].float()  # [B, cq, Hkv, G, dh]
        m = torch.full((b, hkv, g, cq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=torch.float32, device=q.device)
        for j in range(nk):
            logits = torch.einsum("bqkgd,bskd->bkgqs", qi, k[:, j].float()) * scale
            logits = logits + _mask_penalty(qp[i], kp[j], window, prefix)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v[:, j].float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.stack(outs)


def blockwise_attention(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Skv, Hkv, dh]
    v: torch.Tensor,  # [B, Skv, Hkv, dh]
    q_positions: torch.Tensor,  # [Sq] (negative = padding)
    k_positions: torch.Tensor,  # [Skv]
    window: int = 0,
    prefix: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Flash attention forward in plain chunked PyTorch; never holds
    [S, S].  Returns [B, Sq, H, dh] in q's type."""
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv

    cq = min(chunk, sq)
    ck = min(chunk, skv)
    pad_q = (-sq) % cq
    pad_k = (-skv) % ck
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = torch.nn.functional.pad(q_positions, (0, pad_q), value=-1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad_k), value=-1)
    nq, nk = q.shape[1] // cq, k.shape[1] // ck

    qb = q.reshape(b, nq, cq, hkv, g, dh)
    kb = k.reshape(b, nk, ck, hkv, dh)
    vb = v.reshape(b, nk, ck, hkv, dh)
    qp = q_positions.reshape(nq, cq)
    kp = k_positions.reshape(nk, ck)

    outs = _flash_fwd(qb, kb, vb, qp, kp, window, prefix)
    # outs [nq, B, Hkv, G, cq, dh] -> [B, S, H, dh]
    out = outs.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * cq, h, dh)
    return out[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, H, dh] (single new token)
    k_cache: torch.Tensor,  # [B, S, Hkv, dh]
    v_cache: torch.Tensor,  # [B, S, Hkv, dh]
    length: int,  # number of valid cache slots
    window: int = 0,
    positions: Optional[torch.Tensor] = None,  # [B, S] absolute positions
) -> torch.Tensor:
    """Single-step decode attention over a (possibly ring-buffer) cache,
    as the reference computes it: validity by position when ``positions``
    is given, else the first ``length`` slots; the softmax weights are
    cast to the cache's type before the PV product.  Returns [B, H, dh]."""
    b, s, hkv, dh = k_cache.shape
    h = q.shape[1]
    g = h // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, hkv, g, dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if positions is None:
        idx = torch.arange(s, device=q.device)
        valid = (idx[None, :] < length).expand(b, s)
        if window:
            valid = valid & (idx[None, :] >= (length - window))
    else:
        valid = (positions >= 0) & (positions < length)
        if window:
            valid = valid & (positions >= (length - window))
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)

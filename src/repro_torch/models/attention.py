"""Attention: GQA + RoPE, the forward of the blockwise (flash-style)
prefill path, and the reference's position-masked decode attention.

Port of ``repro/models/attention.py``.  The prefill path never holds the
``[S, S]`` logits: an outer loop over query chunks and an inner
online-softmax loop over key chunks keep the live block at ``[B, Hkv, G,
cq, ck]``, with masks (causal, sliding window, prefix-LM) made per block
from positions.  It is plain PyTorch (the reference's ``_flash`` is jnp,
not Pallas), and its backward is the reference's custom VJP
(:class:`_Flash`): the forward saves only the output and the row
log-sum-exp, and the backward recomputes each (query chunk, key chunk)
block's probabilities from them, so training never holds a block's
scores either.  Logits and
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


def _flash_fwd(q, k, v, qp, kp, window: int, prefix: int):
    """q [B, nq, cq, Hkv, G, dh], k/v [B, nk, ck, Hkv, dh], positions
    [nq, cq] / [nk, ck] -> (out [nq, B, Hkv, G, cq, dh] in q's type, lse
    [nq, B, Hkv, G, cq] f32)."""
    b, nq, cq, hkv, g, dh = q.shape
    nk = k.shape[1]
    scale = dh ** -0.5
    outs, lses = [], []
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
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.stack(outs), torch.stack(lses)


def _flash_bwd(q, k, v, qp, kp, out, lse, d_out, window: int, prefix: int):
    """The reference's ``_flash_bwd``: each block's probabilities
    recomputed from (q, k, lse), ``ds = p (dp - rowsum(dO O))``; dq
    accumulated over key chunks for each query chunk, dk and dv over
    query chunks for each key chunk, in f32, returned in the inputs'
    types."""
    b, nq, cq, hkv, g, dh = q.shape
    nk = k.shape[1]
    scale = dh ** -0.5
    delta = (d_out.float() * out.float()).sum(dim=-1)  # [nq, B, Hkv, G, cq]
    d_out = d_out.float()

    def p_block(i, j):
        logits = torch.einsum("bqkgd,bskd->bkgqs", q[:, i].float(), k[:, j].float()) * scale
        logits = logits + _mask_penalty(qp[i], kp[j], window, prefix)
        return torch.exp(logits - lse[i][..., None])  # [B, Hkv, G, cq, ck]

    dq = []
    for i in range(nq):
        acc = torch.zeros((b, cq, hkv, g, dh), dtype=torch.float32, device=q.device)
        for j in range(nk):
            p = p_block(i, j)
            dp = torch.einsum("bkgqd,bskd->bkgqs", d_out[i], v[:, j].float())
            ds = p * (dp - delta[i][..., None])
            acc = acc + torch.einsum("bkgqs,bskd->bqkgd", ds, k[:, j].float()) * scale
        dq.append(acc)
    dk, dv = [], []
    for j in range(nk):
        dk_acc = torch.zeros((b, k.shape[2], hkv, dh), dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for i in range(nq):
            p = p_block(i, j)
            dv_acc = dv_acc + torch.einsum("bkgqs,bkgqd->bskd", p, d_out[i])
            dp = torch.einsum("bkgqd,bskd->bkgqs", d_out[i], v[:, j].float())
            ds = p * (dp - delta[i][..., None])
            dk_acc = dk_acc + torch.einsum("bkgqs,bqkgd->bskd", ds, q[:, i].float()) * scale
        dk.append(dk_acc)
        dv.append(dv_acc)
    return (torch.stack(dq, dim=1).to(q.dtype), torch.stack(dk, dim=1).to(k.dtype),
            torch.stack(dv, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Blocked flash attention whose backward recomputes each block:
    the reference's ``_flash`` custom VJP.  Saved for the backward: the
    inputs, the output and the row log-sum-exp, no block's scores."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, window: int, prefix: int):
        out, lse = _flash_fwd(q, k, v, qp, kp, window, prefix)
        ctx.save_for_backward(q, k, v, qp, kp, out, lse)
        ctx.window, ctx.prefix = window, prefix
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, qp, kp, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, qp, kp, out, lse, d_out, ctx.window, ctx.prefix)
        return dq, dk, dv, None, None, None, None


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
    """Flash attention in plain chunked PyTorch, differentiable through
    :class:`_Flash`; never holds [S, S].  Returns [B, Sq, H, dh] in q's
    type."""
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

    outs = _Flash.apply(qb, kb, vb, qp, kp, window, prefix)
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

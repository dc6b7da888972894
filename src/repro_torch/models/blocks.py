"""Transformer blocks: norms, FFN, GQA attention with a ring-buffer KV
cache, the dense block (optionally MoE), the Hymba block (attention
heads and Mamba heads in parallel) and the xLSTM block (an mLSTM or
sLSTM cell).

Port of ``repro/models/blocks.py``.
Parameters are ``nn.Module``s whose attribute names are the reference's
dict keys; the block bodies are plain functions on them, as in the
reference.  A block's cache is a dict of per-layer views into the
group's cache (``models/model.py::init_cache``), which the block updates
in place: the reference returns new caches instead, and writing in place
keeps one copy of the cache on the card.

``mode`` is ``"train"`` (no cache: the forward, differentiable, of a
train step or a full-sequence pass), ``"prefill"`` (fill the cache) or
``"decode"`` (one step against it).  ``backend`` reaches the kernels through ``kernels/ops.py``:
``None`` launches them for CUDA tensors, ``"torch"`` takes their plain
versions.  The MoE block runs the reference's local path
(``models/moe.py``).  An int8 KV cache
(``kv_quant``) holds each new token's k and v quantized per head
(:func:`_quantize_kv`), and the decode kernel dequantizes as it reads.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .attention import blockwise_attention, rope
from .config import ModelConfig
from .moe import MoE, init_moe_params, moe_local
from .ssm import (
    MLSTM,
    SLSTM,
    Mamba,
    init_mamba_params,
    init_mlstm_params,
    init_slstm_params,
    mamba_mix,
    mlstm_mix,
    slstm_mix,
)


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ norms
class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.scale = _param(d, dtype=dtype, device=device)
        self.bias = _param(d, dtype=dtype, device=device) if kind == "layer" else None


def init_norm(p: Norm) -> None:
    p.scale.fill_(1.0)
    if p.bias is not None:
        p.bias.zero_()


def norm_apply(p: Norm, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """Statistics in f32, normalisation in x's type, as the reference."""
    xf = x.float()
    if kind == "rms":
        ms = (xf * xf).mean(-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps).to(x.dtype)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mu * mu
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    y = y * p.scale.to(x.dtype)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


# -------------------------------------------------------------------- ffn
class FFN(nn.Module):
    def __init__(self, d: int, f: int, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.w1 = _param(d, f, dtype=dtype, device=device)
        self.w2 = _param(f, d, dtype=dtype, device=device)
        self.w3 = _param(d, f, dtype=dtype, device=device) if cfg.glu else None
        self.b1 = _param(f, dtype=dtype, device=device) if cfg.use_bias else None
        self.b2 = _param(d, dtype=dtype, device=device) if cfg.use_bias else None


def init_ffn(p: FFN, gen: torch.Generator) -> None:
    d, f = p.w1.shape
    p.w1.normal_(0.0, d ** -0.5, generator=gen)
    p.w2.normal_(0.0, f ** -0.5, generator=gen)
    if p.w3 is not None:
        p.w3.normal_(0.0, d ** -0.5, generator=gen)
    for b in (p.b1, p.b2):
        if b is not None:
            b.zero_()


def ffn_apply(p: FFN, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The weights are promoted to x's type where x is wider, as JAX
    promotes them (the xLSTM block's FFN sees its f32 residual); where
    the types agree nothing is converted."""
    dt = torch.promote_types(x.dtype, p.w1.dtype)
    x = x.to(dt)
    h = x @ p.w1.to(dt)
    if p.b1 is not None:
        h = h + p.b1
    a = F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if p.w3 is not None:
        a = a * (x @ p.w3.to(dt))
    y = a @ p.w2.to(dt)
    if p.b2 is not None:
        y = y + p.b2
    return y


# -------------------------------------------------------------- attention
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = _param(d, h, dh, **kw)
        self.wk = _param(d, kv, dh, **kw)
        self.wv = _param(d, kv, dh, **kw)
        self.wo = _param(h, dh, d, **kw)
        bias = cfg.use_bias
        self.bq = _param(h, dh, **kw) if bias else None
        self.bk = _param(kv, dh, **kw) if bias else None
        self.bv = _param(kv, dh, **kw) if bias else None
        self.bo = _param(d, **kw) if bias else None
        self.q_norm = _param(dh, **kw) if cfg.qk_norm else None
        self.k_norm = _param(dh, **kw) if cfg.qk_norm else None


def init_attention(p: Attention, gen: torch.Generator) -> None:
    d = p.wq.shape[0]
    h, dh = p.wo.shape[0], p.wo.shape[1]
    for w in (p.wq, p.wk, p.wv):
        w.normal_(0.0, d ** -0.5, generator=gen)
    p.wo.normal_(0.0, (h * dh) ** -0.5, generator=gen)
    for b in (p.bq, p.bk, p.bv, p.bo):
        if b is not None:
            b.zero_()
    for s in (p.q_norm, p.k_norm):
        if s is not None:
            s.fill_(1.0)


def _rmsn(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _quantize_kv(x: torch.Tensor):
    """[B, S, Hkv, dh] -> (int8 values, [B, S, Hkv] f32 scales): the f32
    absmax over dh, ``scale = max(amax, 1e-6) / 127``, values
    ``clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``; a division, as the reference's, not a reciprocal)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _ring_write(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write S new (k, v) at slots ``positions % W`` in place and record
    each slot's position.  k/v: [B, S, Hkv, dh]; positions: [S] on the
    cache's device.  The slots are computed and written on the device, a
    decode step's one slot too, so that a step captured as a CUDA graph
    writes the slot of the position it is replayed at.  An int8 cache
    (one with ``k_scale`` and ``v_scale``) takes the values quantized per
    token and head, and their scales at the same slots.

    A prefill longer than the ring (S > W) has several positions per slot;
    the reference scatters them all and leaves unspecified which write
    wins.  Here only the last W positions are written, each to its own
    slot: last-wins, made explicit.
    """
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    w = ck.shape[1]
    s = k.shape[1]
    if s > w:
        k, v, positions = k[:, -w:], v[:, -w:], positions[-w:]
    slots = (positions % w).long()
    if "k_scale" in cache:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        cache["k_scale"].index_copy_(1, slots, ks)
        cache["v_scale"].index_copy_(1, slots, vs)
    ck.index_copy_(1, slots, k.to(ck.dtype))
    cv.index_copy_(1, slots, v.to(cv.dtype))
    cpos.index_copy_(0, slots, positions.to(cpos.dtype))


def attention_sublayer(cfg: ModelConfig, p: Attention, x: torch.Tensor, cache, mode: str,
                       positions: torch.Tensor, window: int, prefix: int,
                       backend: Optional[str] = None) -> torch.Tensor:
    b, s, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq.reshape(d, h * dh)).reshape(b, s, h, dh)
    k = (x @ p.wk.reshape(d, hkv * dh)).reshape(b, s, hkv, dh)
    v = (x @ p.wv.reshape(d, hkv * dh)).reshape(b, s, hkv, dh)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if p.q_norm is not None:
        q = _rmsn(q, p.q_norm, cfg.norm_eps)
        k = _rmsn(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode in ("train", "prefill"):
        y = blockwise_attention(
            q, k, v, positions, positions, window=window, prefix=prefix, chunk=cfg.attn_chunk
        )
        if mode == "prefill":
            _ring_write(cache, k, v, positions)
    else:  # decode: s == 1, B5 over the valid prefix (kernels/flash_decode.py)
        _ring_write(cache, k, v, positions)
        # min(pos + 1, W) on the device: B5 clamps a device length to [1, W]
        length = positions + 1
        y = ops.flash_decode(
            q[:, 0].reshape(b, hkv, h // hkv, dh), cache["k"], cache["v"], length,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"), backend=backend,
        ).reshape(b, 1, h, dh)
    out = y.reshape(b, s, h * dh) @ p.wo.reshape(h * dh, d)
    if p.bo is not None:
        out = out + p.bo
    return out


# ------------------------------------------------------------ dense block
class DenseBlock(nn.Module):
    """A pre-norm attention block with an FFN, or with routed experts
    (``moe``) and, where the config has them, shared experts: one FFN of
    width ``d_ff * n_shared_experts``.  ``parallel_residual`` (Command R)
    has no ``ln2``."""

    def __init__(self, cfg: ModelConfig, dtype, device, moe: bool):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = None if cfg.parallel_residual else Norm(cfg.d_model, cfg.norm, dtype, device)
        self.moe = self.shared = self.ffn = None
        if moe:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype, device, cfg.glu)
            if cfg.n_shared_experts:
                self.shared = FFN(cfg.d_model, cfg.d_ff * cfg.n_shared_experts, cfg, dtype, device)
        else:
            self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg, dtype, device)


def init_dense_block(p: DenseBlock, gen: torch.Generator) -> None:
    for norm in (p.ln1, p.ln2):
        if norm is not None:
            init_norm(norm)
    init_attention(p.attn, gen)
    if p.moe is not None:
        init_moe_params(p.moe, gen)
    for ffn in (p.shared, p.ffn):
        if ffn is not None:
            init_ffn(ffn, gen)


def _mlp(cfg: ModelConfig, p: DenseBlock, h: torch.Tensor):
    """The block's FFN, or its experts plus the shared ones: (out, aux)."""
    if p.moe is None:
        return ffn_apply(p.ffn, h, cfg), h.new_zeros((), dtype=torch.float32)
    # the reference's moe_apply on one device: its local path
    out, aux = moe_local(
        p.moe, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        act=cfg.act, glu=cfg.glu, renorm=cfg.renorm_topk,
    )
    if p.shared is not None:
        out = out + ffn_apply(p.shared, h, cfg)
    return out, aux


def dense_block_apply(cfg: ModelConfig, p: DenseBlock, x: torch.Tensor, cache, mode: str,
                      positions: torch.Tensor, window: int, backend: Optional[str] = None,
                      prefix: int = 0):
    """One dense or MoE block: returns (x, aux).  ``cache`` (this layer's
    ``{"k", "v", "pos"}``, with ``k_scale`` and ``v_scale`` when int8, or
    None) is updated in place.  ``prefix`` is the prefix-LM length: the
    positions below it attend to each other both ways (PaliGemma's image
    patches); decode ignores it, as the reference does."""
    h = norm_apply(p.ln1, x, cfg.norm, cfg.norm_eps)
    attn_out = attention_sublayer(cfg, p.attn, h, cache, mode, positions, window, prefix, backend)
    if cfg.parallel_residual:
        m_out, aux = _mlp(cfg, p, h)
        return x + attn_out + m_out, aux
    x = x + attn_out
    m_out, aux = _mlp(cfg, p, norm_apply(p.ln2, x, cfg.norm, cfg.norm_eps))
    return x + m_out, aux


# ------------------------------------------------------------ hymba block
class HymbaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mamba = Mamba(cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_kernel, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg, dtype, device)
        # per-path output norms (hymba fuses the two heads' outputs)
        self.attn_out_norm = Norm(cfg.d_model, "rms", dtype, device)
        self.mamba_out_norm = Norm(cfg.d_model, "rms", dtype, device)


def init_hymba_block(p: HymbaBlock, gen: torch.Generator) -> None:
    for norm in (p.ln1, p.ln2, p.attn_out_norm, p.mamba_out_norm):
        init_norm(norm)
    init_attention(p.attn, gen)
    init_mamba_params(p.mamba, gen)
    init_ffn(p.ffn, gen)


def hymba_block_apply(cfg: ModelConfig, p: HymbaBlock, x: torch.Tensor, cache, mode: str,
                      positions: torch.Tensor, window: int,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Hymba: attention heads and Mamba heads run in PARALLEL on the same
    normed input; their normed outputs are averaged [arXiv:2411.13676].
    ``cache`` ({"attn": {...}, "ssm": (conv, h)} of this layer, or None)
    is updated in place."""
    h = norm_apply(p.ln1, x, cfg.norm, cfg.norm_eps)
    attn_out = attention_sublayer(
        cfg, p.attn, h, None if cache is None else cache["attn"], mode, positions, window, 0,
        backend,
    )
    state = None if cache is None else cache["ssm"]
    m_out, (conv_state, ssm_h) = mamba_mix(
        p.mamba, h, cfg, state=state, decode=(mode == "decode"), backend=backend
    )
    if state is not None:
        state[0].copy_(conv_state)
        state[1].copy_(ssm_h)
    fused = 0.5 * (
        norm_apply(p.attn_out_norm, attn_out, "rms", cfg.norm_eps)
        + norm_apply(p.mamba_out_norm, m_out, "rms", cfg.norm_eps)
    )
    x = x + fused
    h2 = norm_apply(p.ln2, x, cfg.norm, cfg.norm_eps)
    return x + ffn_apply(p.ffn, h2, cfg)


# ------------------------------------------------------------ xlstm block
class XLSTMBlock(nn.Module):
    """``ln1``, the cell (``mix``: :class:`MLSTM` or :class:`SLSTM`) and,
    where ``cfg.d_ff > 0``, ``ln2`` and an FFN (xLSTM-1.3B has none: its
    up-projection lives inside the cell)."""

    def __init__(self, cfg: ModelConfig, dtype, device, kind: str):
        super().__init__()
        if kind not in ("mlstm", "slstm"):
            raise ValueError(f"xLSTM block kind must be mlstm or slstm, got {kind!r}")
        self.kind = kind
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        cell = MLSTM if kind == "mlstm" else SLSTM
        self.mix = cell(cfg.d_model, cfg.n_heads, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device) if cfg.d_ff else None
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg, dtype, device) if cfg.d_ff else None


def init_xlstm_block(p: XLSTMBlock, gen: torch.Generator) -> None:
    for norm in (p.ln1, p.ln2):
        if norm is not None:
            init_norm(norm)
    (init_mlstm_params if p.kind == "mlstm" else init_slstm_params)(p.mix, gen)
    if p.ffn is not None:
        init_ffn(p.ffn, gen)


def xlstm_block_apply(cfg: ModelConfig, p: XLSTMBlock, x: torch.Tensor, cache, mode: str,
                      backend: Optional[str] = None) -> torch.Tensor:
    """``x + mix(ln1(x))``, then the optional FFN.  ``cache`` (this
    layer's mLSTM ``(h, n)`` or sLSTM ``(c, n, h, m)``, or None) is
    updated in place: the mLSTM's decode step writes its state where it
    lies, every other new state is copied in.  The mLSTM's output is f32
    (``mlstm_mix``), so x comes back f32 and ``_apply_group`` casts it."""
    h = norm_apply(p.ln1, x, cfg.norm, cfg.norm_eps)
    decode = mode == "decode"
    if p.kind == "mlstm":
        y, new_state = mlstm_mix(p.mix, h, cfg, state=cache, decode=decode, backend=backend)
    else:
        y, new_state = slstm_mix(p.mix, h, cfg, state=cache, decode=decode)
    if cache is not None:
        for dst, src in zip(cache, new_state):
            if src is not dst:
                dst.copy_(src)
    x = x + y
    if p.ffn is not None:
        x = x + ffn_apply(p.ffn, norm_apply(p.ln2, x, cfg.norm, cfg.norm_eps), cfg)
    return x

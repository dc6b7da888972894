"""CausalLM assembly: embeddings -> layer groups -> final norm -> head.

Port of ``repro/models/model.py``: the dense, MoE, Hymba and xLSTM
(mLSTM and sLSTM) blocks, with the reference's model features: the int8 KV cache
(``kv_quant``), PaliGemma's vision prefix (``n_patches`` projected image
features before the prompt, attended both ways) and MusicGen's
codebooks (``n_codebooks`` token streams, summed embeddings, one head
each).  A model is a sequence of *layer groups*, each a
homogeneous run of blocks (a dense model is one group; DeepSeek's leading
dense layers are a group before its MoE group; Hymba's are grouped by
attention window; xLSTM's are runs of mLSTM layers, each followed by
one sLSTM layer).  The reference stacks a
group's parameters and ``lax.scan``s over them; here each layer is its own
module and a Python loop walks them.  The parameters are held in
``param_dtype`` (f32) and are trainable.  Serving (``prefill``,
``serve_step``) runs the blocks on a copy in ``compute_dtype`` (bf16 for
the served configs), made at first use and refreshed in place after the
parameters change (``CausalLM.compute_blocks``), which is the reference's
per-block ``astype`` done ahead of time.  The *serving form*
(``init_params(..., serving=True)``, ``params_from_numpy(...,
serving=True)``) holds the blocks only in ``compute_dtype``, cast once as
that copy is, and nothing else of them: 2 bytes a block parameter where
the two copies hold 6, which is what lets StarCoder2-15B, DeepSeek-MoE-16B
and Moonlight-16B-A3B serve from one card.  It serves the same bits and
cannot be trained.  Training (``forward`` in
``"train"`` mode, ``loss_fn``) casts each block's parameters as it runs
it, differentiably, so the gradients land on the f32 parameters; with
``cfg.remat`` each layer of a scanned group is checkpointed, as the
reference's ``jax.checkpoint`` of its scan body.  The embedding, final
norm and LM head are read from the f32 parameters, as in the reference,
as are the vision projection and the codebook heads.

Every entry point takes an explicit ``device`` (``None`` means the card,
and a host without one raises) and random weights come from a
``torch.Generator`` seeded by the caller.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.config import DeviceLike, resolve_device
from .blocks import (
    DenseBlock,
    HymbaBlock,
    Norm,
    XLSTMBlock,
    dense_block_apply,
    hymba_block_apply,
    init_dense_block,
    init_hymba_block,
    init_norm,
    init_xlstm_block,
    norm_apply,
    xlstm_block_apply,
)
from .config import ModelConfig
from .ssm import HEAD_P

N_META_TOKENS = 128  # hymba learnable meta tokens
SIGLIP_DIM = 1152  # paligemma vision-stub feature width
Position = Union[int, torch.Tensor]  # an int, or a 0-d int32 tensor on the device
M_INIT = -1e30  # the sLSTM stabilizer's initial state


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str  # dense | moe | hymba | mlstm | slstm
    n: int
    window: int = 0  # 0 = full attention
    layer_offset: int = 0  # index of first layer in the whole model


def layer_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """The reference's groups: xLSTM's runs of ``slstm_every - 1`` mLSTM
    layers, each followed by one sLSTM layer (all mLSTM with
    ``slstm_every = 0``); Hymba's runs of layers with the same attention
    window (the full-attention layers apart); a MoE model's leading dense
    layers, then its MoE layers; one group of a dense model.  A dense or
    MoE group's window is ``cfg.sliding_window``.  An unknown
    ``block_kind`` raises ``ValueError``."""
    if cfg.block_kind == "xlstm":
        period = cfg.slstm_every or cfg.n_layers
        groups: List[GroupSpec] = []
        off = 0
        while off < cfg.n_layers:
            n_m = min(period - 1, cfg.n_layers - off)
            if n_m:
                groups.append(GroupSpec("mlstm", n_m, layer_offset=off))
                off += n_m
            if off < cfg.n_layers:
                groups.append(GroupSpec("slstm", 1, layer_offset=off))
                off += 1
        return groups
    if cfg.block_kind == "hymba":
        full = set(cfg.full_attn_layers)
        groups = []
        start = 0
        for i in range(1, cfg.n_layers + 1):
            boundary = i == cfg.n_layers or ((i in full) != (start in full))
            if boundary:
                win = 0 if start in full else cfg.sliding_window
                groups.append(GroupSpec("hymba", i - start, window=win, layer_offset=start))
                start = i
        return groups
    if cfg.block_kind == "moe":
        groups = []
        if cfg.first_dense_layers:
            groups.append(GroupSpec("dense", cfg.first_dense_layers, window=cfg.sliding_window))
        groups.append(
            GroupSpec(
                "moe", cfg.n_layers - cfg.first_dense_layers,
                window=cfg.sliding_window, layer_offset=cfg.first_dense_layers,
            )
        )
        return groups
    if cfg.block_kind != "dense":
        raise ValueError(f"{cfg.name}: unknown block_kind {cfg.block_kind!r}")
    return [GroupSpec("dense", cfg.n_layers, window=cfg.sliding_window)]


def _make_block(cfg: ModelConfig, kind: str, dtype: torch.dtype, device) -> nn.Module:
    if kind in ("dense", "moe"):
        return DenseBlock(cfg, dtype, device, moe=kind == "moe")
    if kind == "hymba":
        return HymbaBlock(cfg, dtype, device)
    if kind in ("mlstm", "slstm"):
        return XLSTMBlock(cfg, dtype, device, kind)
    raise ValueError(kind)


def prefix_tokens(cfg: ModelConfig) -> int:
    """Positions the prefill puts before the prompt: the image patches and
    Hymba's meta tokens (the reference launcher's ``extra``)."""
    return (cfg.n_patches or 0) + (N_META_TOKENS if cfg.block_kind == "hymba" else 0)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ model
class CausalLM(nn.Module):
    """The parameters, named as the reference's pytree: ``embed`` (``[K,
    V, D]`` with K codebooks), ``vision_proj`` (``[1152, D]``, with image
    patches), ``meta_tokens`` (Hymba only), ``groups.{g}.{i}.<block
    keys>`` (layer ``i`` of group ``g``; the reference stacks it as
    ``groups[g][...][i]``), ``final_norm``, and ``heads`` (``[K, D, V]``,
    with codebooks) or ``lm_head`` (untied embeddings).  With ``serving``
    the blocks' parameters are held in ``cfg.compute_dtype`` only (the
    module docstring's serving form, ``self.serving``), every other one in
    ``param_dtype``; their storage is left uninitialised."""

    def __init__(self, cfg: ModelConfig, device: torch.device, serving: bool = False):
        super().__init__()
        self.cfg = cfg
        self.serving = serving
        dt = _dtype(cfg.param_dtype)
        kw = dict(dtype=dt, device=device)
        k = cfg.n_codebooks
        self.embed = _param((k, cfg.vocab_size, cfg.d_model) if k else (cfg.vocab_size, cfg.d_model), **kw)
        self.register_parameter(
            "vision_proj", _param((SIGLIP_DIM, cfg.d_model), **kw) if cfg.n_patches else None)
        self.register_parameter(
            "meta_tokens", _param((N_META_TOKENS, cfg.d_model), **kw) if cfg.block_kind == "hymba" else None)
        self.groups = nn.ModuleList(
            nn.ModuleList(self._new_block(spec.kind, device) for _ in range(spec.n))
            for spec in layer_groups(cfg)
        )
        self.final_norm = Norm(cfg.d_model, cfg.norm, dt, device)
        self.register_parameter(
            "heads", _param((k, cfg.d_model, cfg.vocab_size), **kw) if k else None)
        self.register_parameter(
            "lm_head",
            None if k or cfg.tie_embeddings else _param((cfg.d_model, cfg.vocab_size), **kw))
        self._compute: Dict[torch.dtype, Tuple[List[List[nn.Module]], List[int]]] = {}

    def _new_block(self, kind: str, device) -> nn.Module:
        cfg = self.cfg
        if not self.serving:
            return _make_block(cfg, kind, _dtype(cfg.param_dtype), device)
        # cast on meta as compute_blocks casts (every floating parameter),
        # then storage in the compute dtype only
        blk = _make_block(cfg, kind, _dtype(cfg.param_dtype), torch.device("meta"))
        return blk.to(_dtype(cfg.compute_dtype)).to_empty(device=device).requires_grad_(False)

    def compute_blocks(self, dtype: torch.dtype) -> List[List[nn.Module]]:
        """The blocks in ``dtype`` (the config's ``compute_dtype``) for
        serving, or the parameter modules themselves where the dtypes
        agree.  The copy is made at first use and, whenever a block
        parameter has changed since (an optimizer step, a restored
        checkpoint: any in-place write, which bumps the tensor's version
        counter), refreshed in place, so a CUDA graph captured over it
        reads the new weights.  Every floating parameter is cast, a MoE
        router and the sLSTM's recurrence ``r`` and bias ``b`` too, as the
        reference's per-block ``astype``.  The copy takes no gradient.  The
        serving form hands back its blocks themselves, and raises for any
        other dtype: its blocks hold nothing wider."""
        if self.serving:
            held = _dtype(self.cfg.compute_dtype)
            if dtype != held:
                raise ValueError(f"{self.cfg.name}: the serving form holds its blocks in {held} only, "
                                 f"not {dtype}; build the f32 parameters (serving=False) for another dtype")
            return [list(grp) for grp in self.groups]
        params = list(self.groups.parameters())
        stamp = [p._version for p in params]
        if dtype not in self._compute:
            blocks = []
            for grp in self.groups:
                row = []
                for blk in grp:
                    if any(p.dtype != dtype for p in blk.parameters()):
                        blk = copy.deepcopy(blk).to(dtype).requires_grad_(False)
                    row.append(blk)
                blocks.append(row)
            self._compute[dtype] = (blocks, stamp)
        blocks, seen = self._compute[dtype]
        if seen != stamp:
            with torch.no_grad():
                for grp, copies in zip(self.groups, blocks):
                    for blk, cp in zip(grp, copies):
                        if cp is not blk:
                            for src, dst in zip(blk.parameters(), cp.parameters()):
                                dst.copy_(src)
            self._compute[dtype] = (blocks, stamp)
        return blocks


@torch.no_grad()
def _init_weights(model: CausalLM, gen: torch.Generator) -> None:
    cfg = model.cfg
    model.embed.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    if model.vision_proj is not None:
        model.vision_proj.normal_(0.0, SIGLIP_DIM ** -0.5, generator=gen)
    if model.meta_tokens is not None:
        model.meta_tokens.normal_(0.0, 0.02, generator=gen)
    init = {HymbaBlock: init_hymba_block, DenseBlock: init_dense_block, XLSTMBlock: init_xlstm_block}
    for spec, grp in zip(layer_groups(cfg), model.groups):
        for blk in grp:
            if not model.serving:
                init[type(blk)](blk, gen)
                continue
            # the serving form: the block drawn in param_dtype from the same
            # stream, cast into place, and freed before the next is drawn
            drawn = _make_block(cfg, spec.kind, _dtype(cfg.param_dtype), model.embed.device)
            init[type(drawn)](drawn, gen)
            for dst, src in zip(blk.parameters(), drawn.parameters()):
                dst.copy_(src)
            del drawn
    init_norm(model.final_norm)
    for head in (model.heads, model.lm_head):
        if head is not None:
            head.normal_(0.0, cfg.d_model ** -0.5, generator=gen)


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                serving: bool = False) -> CausalLM:
    """Random weights with the reference's shapes and scales, drawn from
    ``torch.Generator(device).manual_seed(seed)`` (not the reference's
    numbers: ``jax.random`` and torch differ).  With ``serving`` the
    serving form: the same draws in the same order, each block cast as it
    is drawn, so its blocks are bit for bit ``init_params(cfg,
    seed).compute_blocks(compute dtype)`` and its other parameters equal;
    at most one block is held in ``param_dtype`` at a time."""
    dev = resolve_device(device)
    model = CausalLM(cfg, dev, serving=serving)
    _init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def abstract_params(cfg: ModelConfig, serving: bool = False) -> CausalLM:
    """The model on the ``meta`` device: shapes and dtypes, no storage
    (the serving form with ``serving``)."""
    return CausalLM(cfg, torch.device("meta"), serving=serving)


# ------------------------------------------------------------------ caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: DeviceLike = None) -> List[Any]:
    """Per-group decode caches, as the reference lays them out (layer
    first).  A dense or MoE group's is the attention cache itself, ``{"k",
    "v": [n, B, W, Hkv, dh], "pos": [n, W]}``, with ``kv_quant`` k and v in
    int8 and ``"k_scale", "v_scale": [n, B, W, Hkv]`` f32 beside them; a
    Hymba group's is ``{"attn": <the same>, "ssm": (conv [n, B, K-1, dI],
    h [n, B, H, N, 64] f32)}``; an mLSTM group's ``(h [n, B, H, dh, dh],
    n [n, B, H, dh])`` and an sLSTM group's ``(c, n, h, m)`` ``[n, B, H,
    dh]`` each, all f32, m at -1e30 (constant in ``max_len``).  W is
    ``max_len`` on full-attention layers and ``min(max_len, window)`` on
    window layers.  max_len includes the prefix positions
    (``prefix_tokens``)."""
    dev = resolve_device(device)
    dt = _dtype(cfg.compute_dtype)
    dh = cfg.resolved_head_dim
    caches: List[Any] = []
    for spec in layer_groups(cfg):
        f32 = dict(dtype=torch.float32, device=dev)
        if spec.kind == "mlstm":
            caches.append((torch.zeros((spec.n, batch, cfg.n_heads, dh, dh), **f32),
                           torch.zeros((spec.n, batch, cfg.n_heads, dh), **f32)))
            continue
        if spec.kind == "slstm":
            # four tensors, where the reference reuses one array for c, n
            # and h: the port writes each in place
            shape = (spec.n, batch, cfg.n_heads, dh)
            caches.append((torch.zeros(shape, **f32), torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                           torch.full(shape, M_INIT, **f32)))
            continue
        w = min(max_len, spec.window) if spec.window else max_len
        kv_dt = torch.int8 if cfg.kv_quant else dt
        attn = {
            "k": torch.zeros((spec.n, batch, w, cfg.n_kv_heads, dh), dtype=kv_dt, device=dev),
            "v": torch.zeros((spec.n, batch, w, cfg.n_kv_heads, dh), dtype=kv_dt, device=dev),
            "pos": torch.full((spec.n, w), -1, dtype=torch.int32, device=dev),
        }
        if cfg.kv_quant:
            for key in ("k_scale", "v_scale"):
                attn[key] = torch.zeros((spec.n, batch, w, cfg.n_kv_heads), dtype=torch.float32, device=dev)
        if spec.kind != "hymba":
            caches.append(attn)
            continue
        nh = cfg.d_inner // HEAD_P
        caches.append({
            "attn": attn,
            "ssm": (
                torch.zeros((spec.n, batch, cfg.conv_kernel - 1, cfg.d_inner), dtype=dt, device=dev),
                torch.zeros((spec.n, batch, nh, cfg.ssm_state, HEAD_P), dtype=torch.float32, device=dev),
            ),
        })
    return caches


def _layer_cache(cache: Any, i: int) -> Any:
    """Layer ``i``'s views into a group's cache (dicts and tuples of
    ``[n, ...]`` tensors)."""
    if isinstance(cache, dict):
        return {key: _layer_cache(t, i) for key, t in cache.items()}
    if isinstance(cache, tuple):
        return tuple(_layer_cache(t, i) for t in cache)
    return cache[i]


# ----------------------------------------------------------------- forward
def _block(cfg: ModelConfig, spec: GroupSpec, blk: nn.Module, x: torch.Tensor, cache, mode: str,
           positions: torch.Tensor, prefix: int,
           backend: Optional[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer in the compute dtype: (x, the aux loss of a dense or MoE
    layer, 0 without experts; None for the other kinds)."""
    cdt = _dtype(cfg.compute_dtype)
    aux = None
    if spec.kind == "hymba":
        x = hymba_block_apply(cfg, blk, x.to(cdt), cache, mode, positions, spec.window, backend)
    elif spec.kind in ("mlstm", "slstm"):
        x = xlstm_block_apply(cfg, blk, x.to(cdt), cache, mode, backend)
    else:
        x, aux = dense_block_apply(cfg, blk, x.to(cdt), cache, mode, positions, spec.window, backend, prefix)
    return x.to(cdt), aux


class _Call(nn.Module):
    """Holds one block so that ``torch.func.functional_call`` can run a
    block function on it with its parameters replaced."""

    def __init__(self, blk: nn.Module):
        super().__init__()
        self.blk = blk

    def forward(self, fn, *args):
        return fn(self.blk, *args)


def _train_block(cfg: ModelConfig, spec: GroupSpec, blk: nn.Module, x: torch.Tensor,
                 positions: torch.Tensor, prefix: int, backend: Optional[str]):
    """One layer of the train forward on the f32 parameters: each is
    cast to the compute dtype as the layer runs, as the reference's
    per-block ``astype``, so autograd carries the gradients back to the
    f32 parameters (a cast to the same dtype is the parameter itself)."""
    cdt = _dtype(cfg.compute_dtype)
    cast = {"blk." + n: p.to(cdt) for n, p in blk.named_parameters()}

    def run(b, x_):
        return _block(cfg, spec, b, x_, None, "train", positions, prefix, backend)

    return torch.func.functional_call(_Call(blk), cast, (run, x))


def _apply_group(cfg: ModelConfig, spec: GroupSpec, blocks, x: torch.Tensor, cache, mode: str,
                 positions: torch.Tensor, prefix: int,
                 backend: Optional[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The group's layers in order: (x, the sum of their aux losses in
    train mode, else None).  Training with ``cfg.remat`` checkpoints each
    layer of a group the reference scans (``scan_layers`` and more than
    one layer), as its ``jax.checkpoint`` of the scan body: the backward
    recomputes the layer from its input."""
    if mode != "train":
        for i, blk in enumerate(blocks):
            x, _ = _block(cfg, spec, blk, x, _layer_cache(cache, i), mode, positions, prefix, backend)
        return x, None
    aux_total = x.new_zeros((), dtype=torch.float32)
    remat = cfg.remat and cfg.scan_layers and spec.n > 1 and torch.is_grad_enabled()
    for blk in blocks:
        if remat:
            x, aux = checkpoint(_train_block, cfg, spec, blk, x, positions, prefix, backend,
                                use_reentrant=False)
        else:
            x, aux = _train_block(cfg, spec, blk, x, positions, prefix, backend)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def embed_inputs(cfg: ModelConfig, params: CausalLM, batch: Dict[str, torch.Tensor],
                 start_pos: Position = 0,
                 mode: str = "train") -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Assemble the input sequence.  Returns (x [B,S',D], positions [S']
    int32 on x's device, prefix, n_prefix_tokens): ``prefix`` is the
    prefix-LM length (the image patches, attended both ways) and
    ``n_prefix_tokens`` the leading positions that are not the prompt's.
    Codebook tokens [B, S, K] sum their K embeddings in codebook order in
    the parameter dtype, as the reference's ``sum``.  Outside decode
    mode, the projected ``batch["patches"]`` [B, n_patches, 1152] and
    Hymba's meta tokens lead the sequence (in decode they live in the
    cache from prefill).  ``start_pos`` is an int or a 0-d int32 tensor on
    the device, whose value is never read on the host."""
    tokens = batch["tokens"]
    dt = _dtype(cfg.compute_dtype)
    if cfg.n_codebooks:
        x = params.embed[0][tokens[..., 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + params.embed[k][tokens[..., k]]
        x = x.to(dt)
    else:
        x = params.embed[tokens].to(dt)
    prefix = n_prefix = 0
    b = tokens.shape[0]
    if mode != "decode":
        if cfg.n_patches and "patches" in batch:
            patches = batch["patches"].to(dt) @ params.vision_proj.to(dt)
            x = torch.cat([patches, x], dim=1)
            prefix = n_prefix = patches.shape[1]  # bidirectional over the image prefix
        if cfg.block_kind == "hymba":
            meta = params.meta_tokens[None].to(dt).expand(b, N_META_TOKENS, cfg.d_model)
            x = torch.cat([meta, x], dim=1)
            n_prefix = N_META_TOKENS
    if isinstance(start_pos, torch.Tensor):
        offsets = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        positions = start_pos.to(torch.int32) + offsets
    else:
        positions = torch.arange(
            start_pos, start_pos + x.shape[1], dtype=torch.int32, device=x.device
        )
    return x, positions, prefix, n_prefix


def forward(cfg: ModelConfig, params: CausalLM, batch: Dict[str, torch.Tensor],
            caches: Optional[List[Any]] = None, mode: str = "train", start_pos: Position = 0,
            backend: Optional[str] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (hidden [B,S,D] after the final norm, with the image
    patches and Hymba's meta tokens dropped outside decode; in "train"
    mode the MoE aux loss, f32, summed over the layers, else None), as
    the reference's ``forward`` less its caches.  With ``mode`` "prefill"
    or "decode" the caches are updated in place, under
    ``torch.no_grad()``, and the aux loss, which serving never reads, is
    not summed.  In "train" mode the forward runs on the f32 parameters
    (``_train_block``) and builds the autograd graph when gradients are
    enabled; the kernels have no backward, so a train forward that needs
    gradients on CUDA tensors asks for ``backend="torch"``
    (``kernels/ops.py`` raises otherwise).  ``start_pos`` is the position
    of the first token (an int, or a 0-d int32 tensor on the device)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    if (caches is None) != (mode == "train"):
        raise ValueError(f"mode {mode!r} {'needs' if mode != 'train' else 'takes no'} caches")
    with torch.set_grad_enabled(mode == "train" and torch.is_grad_enabled()):
        x, positions, prefix, n_prefix = embed_inputs(cfg, params, batch, start_pos, mode)
        blocks_by_group = params.groups if mode == "train" else params.compute_blocks(_dtype(cfg.compute_dtype))
        aux_total = x.new_zeros((), dtype=torch.float32) if mode == "train" else None
        for gi, (spec, blocks) in enumerate(zip(layer_groups(cfg), blocks_by_group)):
            gc = None if caches is None else caches[gi]
            x, aux = _apply_group(cfg, spec, blocks, x, gc, mode, positions, prefix, backend)
            if aux is not None:
                aux_total = aux_total + aux
        x = norm_apply(params.final_norm, x, cfg.norm, cfg.norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        return x, aux_total


def _head_matrix(cfg: ModelConfig, params: CausalLM) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


# -------------------------------------------------------------------- loss
def _xent_chunk(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor):
    """One chunk's (sum of masked -log p, count of labels >= 0), on f32
    logits [B, c, V]."""
    logits = h.float() @ head_w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_xent(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without holding [B, S, V]: a loop over chunks of S,
    each checkpointed under autograd so the backward recomputes that
    chunk's f32 logits [B, c, V] instead of keeping them, as the
    reference's checkpointed scan.  Labels < 0 are masked; a ragged S is
    padded with label -1.  Returns (loss_sum, token_count), f32."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    labels = labels.long()
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled()
    for i in range(0, s + pad, c):
        h, lab = hidden[:, i:i + c], labels[:, i:i + c]
        if grad:
            ls, ct = checkpoint(_xent_chunk, h, head_w, lab, use_reentrant=False)
        else:
            ls, ct = _xent_chunk(h, head_w, lab)
        loss_sum = loss_sum + ls
        count = count + ct
    return loss_sum, count


def loss_fn(cfg: ModelConfig, params: CausalLM, batch: Dict[str, torch.Tensor],
            backend: Optional[str] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn``: the train forward, the chunked
    cross-entropy of ``batch["labels"]`` (summed over the codebook heads
    with codebooks; Hymba's meta tokens and the image patches are
    already dropped by ``forward``), mean over the labelled tokens, plus
    ``router_aux_weight`` times the aux loss for MoE.  Returns (loss,
    {"xent", "aux"}), f32 scalars on the device."""
    hidden, aux = forward(cfg, params, batch, mode="train", backend=backend)
    labels = batch["labels"]
    if cfg.n_codebooks:
        total = count = hidden.new_zeros((), dtype=torch.float32)
        for k in range(cfg.n_codebooks):
            ls, ct = chunked_xent(hidden, params.heads[k], labels[..., k], cfg.loss_chunk)
            total = total + ls
            count = count + ct
    else:
        total, count = chunked_xent(hidden, _head_matrix(cfg, params), labels, cfg.loss_chunk)
    xent = total / torch.clamp(count, min=1.0)
    loss = xent + cfg.router_aux_weight * aux if cfg.n_experts else xent
    return loss, {"xent": xent, "aux": aux}


# -------------------------------------------------------------- serve step
@torch.no_grad()
def serve_step(cfg: ModelConfig, params: CausalLM, caches: List[Any], tokens: torch.Tensor,
               pos: Position, backend: Optional[str] = None) -> torch.Tensor:
    """One decode step of tokens [B, 1] ([B, 1, K] with codebooks) at
    position ``pos``; returns logits [B, vocab] ([B, K, vocab]) in f32 and
    updates ``caches`` in place.  ``pos`` is a 0-d
    int32 tensor on the model's device, as the reference's traced
    ``jnp.int32``, or an int, made into the step's positions on the device
    once (``embed_inputs``).  Nothing on the step reads a device value on
    the host, so the step can be captured as a CUDA graph
    (``launch/steps.py::make_serve_step``)."""
    hidden, _ = forward(cfg, params, {"tokens": tokens}, caches=caches, mode="decode",
                        start_pos=pos, backend=backend)
    h = hidden[:, -1].float()
    if cfg.n_codebooks:
        return torch.einsum("bd,kdv->bkv", h, params.heads.float())
    return h @ _head_matrix(cfg, params).float()


def prefill(cfg: ModelConfig, params: CausalLM, batch: Dict[str, torch.Tensor],
            caches: List[Any], backend: Optional[str] = None) -> torch.Tensor:
    """Run the prompt (``batch["tokens"]``, and ``batch["patches"]`` with
    the vision prefix) through the model filling ``caches`` in place;
    returns the last hidden state [B, D]."""
    hidden, _ = forward(cfg, params, batch, caches=caches, mode="prefill", backend=backend)
    return hidden[:, -1]

"""Step builders: train_step / prefill_step / serve_step closures over a
config.

Port of ``repro/launch/steps.py``.  The reference's steps are pure
functions that it jits; these update the model and the caches in place.
The train step (:func:`make_train_step`) and the prefill run eagerly;
the train step takes the plain routes (``backend="torch"``), since the
kernels have no backward, and so launches no counted kernel.
The decode step on the card runs as one CUDA graph, the counterpart of
the reference's ``jax.jit(serve_step)`` with ``pos`` traced
(:class:`GraphedServeStep`); :func:`make_eager_serve_step` runs it op by
op, for comparisons.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.graphs import Captured, run_on_side_stream
from ..models import CausalLM, ModelConfig, loss_fn, prefill, serve_step
from ..models.model import Position
from ..optim import AdamWState, adamw_update, cosine_schedule

Batch = Dict[str, torch.Tensor]


def loss_and_grads(cfg: ModelConfig, params: CausalLM,
                   batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(loss, metrics, grads keyed by parameter name) of one batch through
    the plain routes, as the reference's ``train_step`` computes them
    before its update: with ``cfg.grad_accum > 1`` the batch is split
    into that many micro-batches of contiguous rows (the reference's
    ``a.reshape(accum, B // accum, ...)``), run one at a time, their
    gradients summed in f32 and divided by the count, the loss their
    mean and the metrics ({"xent", "aux"}) the last one's.  The model is
    not changed.  A model in the serving form raises ``ValueError``: it
    holds no f32 block parameters to take gradients on."""
    if params.serving:
        raise ValueError(f"{cfg.name}: the serving form holds its blocks in {cfg.compute_dtype} only and "
                         "cannot be trained; train the f32 parameters (init_params(..., serving=False))")
    accum = max(1, cfg.grad_accum)
    names, ps = zip(*params.named_parameters())

    def grad_of(mb: Batch):
        loss, metrics = loss_fn(cfg, params, mb, backend="torch")
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads

    if accum == 1:
        loss, metrics, grads = grad_of(batch)
        return loss, metrics, dict(zip(names, grads))
    rows = {k: a.shape[0] for k, a in batch.items()}
    if any(n % accum for n in rows.values()):
        raise ValueError(f"grad_accum={accum} does not divide the batch's rows {rows}")
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps]
    loss_sum = ps[0].new_zeros((), dtype=torch.float32)
    for i in range(accum):
        mb = {k: a.reshape(accum, a.shape[0] // accum, *a.shape[1:])[i] for k, a in batch.items()}
        loss, metrics, grads = grad_of(mb)
        acc = [a + g.float() for a, g in zip(acc, grads)]
        loss_sum = loss_sum + loss
    return loss_sum / accum, metrics, {n: a / accum for n, a in zip(names, acc)}


def make_train_step(cfg: ModelConfig, base_lr: float = 3e-4, warmup: int = 2000, total: int = 100_000):
    """The reference's train step: :func:`loss_and_grads`, the cosine
    learning rate at the optimizer's step before its increment (so the
    first step of a warmup runs at lr 0), then ``adamw_update``, whose new
    values are written into the model's parameters in place.
    ``train_step(params, opt_state, batch)`` returns (params, the new
    optimizer state, {"loss", "xent", "aux", "grad_norm", "lr"}), the
    metrics f32 0-d tensors on the device (reading one waits for the
    step).  A model in the serving form raises ``ValueError`` before any
    work (:func:`loss_and_grads`)."""

    def train_step(params: CausalLM, opt_state: AdamWState, batch: Batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch)
        lr = cosine_schedule(opt_state.step, base_lr, warmup, total)
        named = dict(params.named_parameters())
        new_p, new_opt, om = adamw_update(named, grads, opt_state, lr)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new_p[k])
        return params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, backend: Optional[str] = None):
    def prefill_step(params, batch, caches):
        return prefill(cfg, params, batch, caches, backend=backend)

    return prefill_step


def make_eager_serve_step(cfg: ModelConfig, backend: Optional[str] = None):
    """The decode step op by op, on any device."""

    def step(params, caches, tokens, pos):
        return serve_step(cfg, params, caches, tokens, pos, backend=backend)

    return step


class GraphedServeStep:
    """The decode step as one CUDA graph on the card; eager on the CPU.

    The first call with given parameters, caches and token shape runs the
    step eagerly (a real step, and the warm-up), then captures one step
    over a static token buffer and a 0-d int32 position buffer, which the
    graph advances by one after the step.  Every later call copies the
    tokens in, sets the position only where it is not the one the graph
    left (an int it has counted to, or a tensor, which is copied), replays
    and returns a clone of the logits.  The graph reads the parameters and
    writes the caches in place, at the addresses it was captured with;
    the blocks' compute-dtype copy it reads is refreshed in place first
    if the parameters have changed since (``CausalLM.compute_blocks``)."""

    def __init__(self, cfg: ModelConfig, backend: Optional[str] = None):
        self.cfg = cfg
        self.backend = backend
        self.graph: Optional[Captured] = None
        self._key = None
        self._next_pos: Optional[int] = None

    def _step(self, params, caches, tokens, pos):
        return serve_step(self.cfg, params, caches, tokens, pos, backend=self.backend)

    def __call__(self, params, caches, tokens: torch.Tensor, pos: Position) -> torch.Tensor:
        if not tokens.is_cuda:
            return self._step(params, caches, tokens, pos)
        key = (id(params), id(caches), tuple(tokens.shape), tokens.dtype)
        if self.graph is None or key != self._key:
            logits = run_on_side_stream(self._step, params, caches, tokens, pos)

            def body(tok, p):
                out = self._step(params, caches, tok, p)
                p.add_(1)
                return out

            example = (tokens, torch.zeros((), dtype=torch.int32, device=tokens.device))
            self.graph = Captured(body, example, keep=(params, caches))
            self._key, self._next_pos = key, None
            return logits
        counted = isinstance(pos, int) and pos == self._next_pos
        self._next_pos = pos + 1 if isinstance(pos, int) else None
        params.compute_blocks(getattr(torch, self.cfg.compute_dtype))  # in place, if trained since
        return self.graph((tokens, None if counted else pos))


def make_serve_step(cfg: ModelConfig, backend: Optional[str] = None) -> GraphedServeStep:
    """The decode step, captured as a CUDA graph on the card."""
    return GraphedServeStep(cfg, backend)

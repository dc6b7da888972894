"""Step builders: prefill_step / serve_step closures over a config.

Port of ``repro/launch/steps.py`` minus ``make_train_step`` (the train
path is not ported yet).  The reference's steps are pure functions that
it jits; these update the caches in place.  The prefill runs eagerly.
The decode step on the card runs as one CUDA graph, the counterpart of
the reference's ``jax.jit(serve_step)`` with ``pos`` traced
(:class:`GraphedServeStep`); :func:`make_eager_serve_step` runs it op by
op, for comparisons.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.graphs import Captured, run_on_side_stream
from ..models import ModelConfig, prefill, serve_step
from ..models.model import Position


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
    writes the caches in place, at the addresses it was captured with."""

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
        return self.graph((tokens, None if counted else pos))


def make_serve_step(cfg: ModelConfig, backend: Optional[str] = None) -> GraphedServeStep:
    """The decode step, captured as a CUDA graph on the card."""
    return GraphedServeStep(cfg, backend)

"""Step builders: prefill_step / serve_step closures over a config.

Port of ``repro/launch/steps.py`` minus ``make_train_step`` (the train
path is not ported yet).  The reference's steps are pure functions to be
jitted; these run eagerly and update the caches in place.
"""
from __future__ import annotations

from typing import Optional

from ..models import ModelConfig, prefill, serve_step


def make_prefill_step(cfg: ModelConfig, backend: Optional[str] = None):
    def prefill_step(params, batch, caches):
        return prefill(cfg, params, batch, caches, backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig, backend: Optional[str] = None):
    def step(params, caches, tokens, pos):
        return serve_step(cfg, params, caches, tokens, pos, backend=backend)

    return step

"""Transformer substrate, as far as the port runs it: Hymba (parallel
attention + Mamba heads) served by prefill and greedy decode."""
from .config import ModelConfig
from .model import (
    CausalLM,
    abstract_params,
    forward,
    init_cache,
    init_params,
    layer_groups,
    prefill,
    serve_step,
)
from .params import params_from_numpy

__all__ = [
    "CausalLM",
    "ModelConfig",
    "abstract_params",
    "forward",
    "init_cache",
    "init_params",
    "layer_groups",
    "params_from_numpy",
    "prefill",
    "serve_step",
]

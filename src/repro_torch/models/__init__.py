"""Transformer substrate: dense, MoE, Hymba (parallel attention + Mamba
heads) and xLSTM (mLSTM and sLSTM) blocks, served by prefill and greedy
decode."""
from .config import ModelConfig
from .model import (
    CausalLM,
    abstract_params,
    forward,
    init_cache,
    init_params,
    layer_groups,
    prefill,
    prefix_tokens,
    serve_step,
)
from .moe import MoE, moe_local, router
from .params import params_from_numpy

__all__ = [
    "CausalLM",
    "MoE",
    "ModelConfig",
    "abstract_params",
    "forward",
    "init_cache",
    "init_params",
    "layer_groups",
    "moe_local",
    "params_from_numpy",
    "prefill",
    "prefix_tokens",
    "router",
    "serve_step",
]

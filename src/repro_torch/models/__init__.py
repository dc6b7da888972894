"""Transformer substrate: dense, MoE, Hymba (parallel attention + Mamba
heads) and xLSTM (mLSTM and sLSTM) blocks, served by prefill and greedy
decode and trained through ``loss_fn``."""
from .config import ModelConfig
from .model import (
    CausalLM,
    abstract_params,
    chunked_xent,
    forward,
    init_cache,
    init_params,
    layer_groups,
    loss_fn,
    prefill,
    prefix_tokens,
    serve_step,
)
from .moe import MoE, moe_local, router
from .params import params_from_numpy, params_to_numpy

__all__ = [
    "CausalLM",
    "MoE",
    "ModelConfig",
    "abstract_params",
    "chunked_xent",
    "forward",
    "init_cache",
    "init_params",
    "layer_groups",
    "loss_fn",
    "moe_local",
    "params_from_numpy",
    "params_to_numpy",
    "prefill",
    "prefix_tokens",
    "router",
    "serve_step",
]

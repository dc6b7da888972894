"""Pipe-it on one node of cards: the paper's scheduling algorithms applied
to the cards of one host joined by NVLink.

Port of ``repro/core/tpu_pipeit.py``.  A pipeline stage is a GROUP of
cards; intra-stage parallelism is tensor-parallel sharding (the paper's
kernel-level split), and the stage boundary moves one activation tensor
over NVLink (the CCI analogue).  "Heterogeneity" is group size: an
8-card stage processes a layer faster than a 2-card stage, with concave
returns, since every TP layer pays an all-reduce whose cost grows with
group size (paper Fig. 11), which makes merge_stage's Eq. 14 stop rule
meaningful.

The per-layer cost model plays the role of Eq. 5/8: analytic roofline
terms per layer on an n-card group,

    t_l(n) = max(flops_l / (n * PEAK), bytes_l / (n * HBM))
             + ar_bytes(n) / LINK          (0 when n == 1)

with ar_bytes the ring all-reduce traffic of the layer's TP collectives
and the card's rates from ``roofline/analysis.py::card_peaks`` (bf16
FLOP/s, HBM bytes/s, NVLink bytes/s each way).  The same
``pipe_it_search`` then picks stage groups + layer ranges.  It plans
only: nothing here runs on a card.

Where it departs from the reference: the reference divides a step's
tokens by a data axis of 16 chips fixed by its pod; here that is
``data_shards``, 1 by default, since a node's cards all sit on the model
axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..configs.shapes import InputShape
from ..models.config import ModelConfig
from ..roofline.analysis import card_peaks
from .dse import pipe_it_search
from .pipeline import Pipeline, PipelinePlan, TimeMatrix
from .platform import CoreType, HeteroPlatform

# Stage-boundary activation send latency: the reference's model constant
# (``tpu_pipeit.HANDOFF_S``), kept; a peer-to-peer copy's latency over
# NVLink has not been measured for this model.
HANDOFF_S = 2e-6


@dataclasses.dataclass(frozen=True)
class Rates:
    """What the cost model reads of a card: bf16 FLOP/s, HBM bytes/s, the
    stage boundary's link bytes/s (each way) and its handoff latency."""

    peak: float
    hbm: float
    link: float
    handoff_s: float = HANDOFF_S


def card_rates(card: str = "H100") -> Rates:
    """The rates of a card of :data:`roofline.analysis.PEAKS`."""
    p = card_peaks(card)
    return Rates(peak=p.bf16_flops, hbm=p.hbm_bytes_per_s, link=p.nvlink_bytes_per_s)


@dataclasses.dataclass(frozen=True)
class GpuLayerCost:
    name: str
    flops_per_token: float  # forward flops per token
    weight_bytes: float  # parameter bytes the layer streams per step
    act_bytes_per_token: float  # residual-stream activation bytes
    n_collectives: int  # TP all-reduces per layer (attn out, ffn out, ...)


def layer_costs(cfg: ModelConfig, seq_len: int) -> List[GpuLayerCost]:
    """Analytic per-layer costs from the config (the Eq. 3-4 analogue:
    statically-available descriptors -> cost terms)."""
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    out: List[GpuLayerCost] = []
    act = d * 2  # bf16 residual stream per token

    for li in range(cfg.n_layers):
        attn_p = d * (h + 2 * kv + h) * dh  # wq, wk, wv, wo
        window = cfg.sliding_window or seq_len
        if cfg.full_attn_layers and li in cfg.full_attn_layers:
            window = seq_len
        score = 2 * min(window, seq_len) * h * dh  # qk^T + pv per token
        if cfg.block_kind == "xlstm":
            # mLSTM: qkv + gates + out projections; state update O(N*P)
            p = d * d * 5
            fl = 2 * p + 2 * dh * (dh + 1) * cfg.n_heads
            out.append(GpuLayerCost(f"l{li}", fl, p * 2, act, 2))
            continue
        if cfg.block_kind == "hymba":
            mamba_p = d * 2 * cfg.d_inner + cfg.d_inner * (d + 2 * cfg.ssm_state)
            ffn_p = d * cfg.d_ff * (3 if cfg.glu else 2)
            p = attn_p + mamba_p + ffn_p
            fl = 2 * p + score + 2 * cfg.d_inner * cfg.ssm_state
            out.append(GpuLayerCost(f"l{li}", fl, p * 2, act, 3))
            continue
        if cfg.n_experts and li >= cfg.first_dense_layers:
            expert_p = cfg.d_model * cfg.d_ff * (3 if cfg.glu else 2)
            active = expert_p * cfg.top_k + expert_p * cfg.n_shared_experts
            weights = expert_p * cfg.n_experts + expert_p * cfg.n_shared_experts
            p_flops = attn_p + active
            p_bytes = (attn_p + weights) * 2
            fl = 2 * p_flops + score
            out.append(GpuLayerCost(f"l{li}", fl, p_bytes, act, 3))
            continue
        ffn_p = d * cfg.d_ff * (3 if cfg.glu else 2)
        p = attn_p + ffn_p
        fl = 2 * p + score
        out.append(GpuLayerCost(f"l{li}", fl, p * 2, act, 2))
    return out


def gpu_platform(n_cards: int = 8, rates: Optional[Rates] = None) -> HeteroPlatform:
    """One homogeneous card type; stage capability = group size."""
    rates = rates or card_rates()
    return HeteroPlatform(
        name=f"gpu-nvlink-{n_cards}",
        core_types=(CoreType("c", n_cards, 1.0),),
        boundary_bytes_per_s=rates.link,
        boundary_latency_s=rates.handoff_s,
    )


def stage_time(cost: GpuLayerCost, n: int, tokens_per_step: float, rates: Optional[Rates] = None) -> float:
    rates = rates or card_rates()
    compute = cost.flops_per_token * tokens_per_step / (n * rates.peak)
    memory = cost.weight_bytes / (n * rates.hbm)
    t = max(compute, memory)
    if n > 1:
        # ring all-reduce of the layer output: 2 (n-1)/n * bytes over NVLink
        ar = cost.n_collectives * 2 * (n - 1) / n * (
            cost.act_bytes_per_token * tokens_per_step
        )
        t += ar / rates.link
    return t


def time_matrix(
    costs: Sequence[GpuLayerCost], n_cards: int, tokens_per_step: float, rates: Optional[Rates] = None
) -> TimeMatrix:
    rates = rates or card_rates()
    return [
        {("c", n): stage_time(c, n, tokens_per_step, rates) for n in range(1, n_cards + 1)}
        for c in costs
    ]


def plan_stages(
    cfg: ModelConfig,
    shape: InputShape,
    n_cards: int = 8,
    mode: str = "best",
    data_shards: int = 1,
    rates: Optional[Rates] = None,
) -> Tuple[PipelinePlan, Dict[str, float]]:
    """Run the paper's DSE over a node's cards.

    tokens_per_step: decode -> batch tokens; train/prefill -> tokens in
    flight per pipeline step (batch * seq), each divided by
    ``data_shards`` replicas of the pipeline that split the batch."""
    rates = rates or card_rates()
    if shape.kind == "decode":
        tokens = shape.global_batch / data_shards
    else:
        tokens = shape.global_batch * shape.seq_len / data_shards
    costs = layer_costs(cfg, shape.seq_len)
    T = time_matrix(costs, n_cards, tokens, rates)
    plat = gpu_platform(n_cards, rates)
    plan = pipe_it_search(cfg.n_layers, plat, T, mode=mode)
    tp_pipe = plan.throughput(T)

    # baseline: pure tensor-parallel over all cards (the "kernel-level"
    # strategy: one stage, every layer split n_cards ways)
    base = PipelinePlan(Pipeline((("c", n_cards),)), (tuple(range(cfg.n_layers)),))
    tp_base = base.throughput(T)
    return plan, {
        "pipeline_steps_per_s": tp_pipe,
        "tp_baseline_steps_per_s": tp_base,
        "gain": tp_pipe / tp_base - 1,
        "tokens_per_step": tokens,
    }

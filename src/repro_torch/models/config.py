"""Model configuration for the assigned architectures.

One frozen dataclass covers all six architecture families; family-specific
fields default to inert values.  ``reduced()`` produces the CPU smoke-test
variant (2 layers, d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # block structure
    block_kind: str = "dense"  # dense | moe | xlstm | hymba
    parallel_residual: bool = False  # command-r style
    norm: str = "rms"  # rms | layer
    norm_eps: float = 1e-5
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP with gelu)
    glu: bool = True
    use_bias: bool = False
    tie_embeddings: bool = False
    qk_norm: bool = False  # olmoe

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 -> full attention
    full_attn_layers: Tuple[int, ...] = ()  # hymba: layers that stay full

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0  # deepseek: leading dense-FFN layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    renorm_topk: bool = True  # olmoe: False

    # ssm / hybrid
    ssm_state: int = 16
    ssm_expand: int = 2
    ssd_chunk: int = 128  # SSD intra-chunk size (score bytes scale with it)
    conv_kernel: int = 4
    slstm_every: int = 0  # xlstm: one sLSTM per this many layers (period)

    # vlm / audio frontends (stubbed: precomputed embeddings)
    n_patches: int = 0  # paligemma: image patch embeddings per example
    n_codebooks: int = 0  # musicgen: EnCodec codebooks

    # numerics / lowering
    grad_accum: int = 1  # microbatches per train step (gradient accumulation)
    act_shard: bool = True  # shard saved layer carries over 'model' (mem<->coll trade)
    kv_quant: bool = False  # int8 KV cache (per-token-per-head absmax scales)
    act_shard_axis: str = "d"  # 'd' (tensor) | 'seq' (sequence-parallel carries)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512  # blockwise-attention chunk (train path)
    loss_chunk: int = 512  # chunked softmax-xent over sequence

    # citation for the config values
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def supports_long_context(self) -> bool:
        """long_500k eligibility: sub-quadratic decode state."""
        return self.block_kind in ("xlstm", "hymba") or self.sliding_window > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (one pattern period for xlstm),
        d_model <= 512, <= 4 experts, small vocab."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        layers = 2 if self.slstm_every == 0 else self.slstm_every
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            full_attn_layers=tuple(i for i in self.full_attn_layers if i < layers),
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            attn_chunk=64,
            loss_chunk=64,
            remat=False,
        )

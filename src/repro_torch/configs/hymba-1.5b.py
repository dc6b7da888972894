"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676].

32 layers, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, vocab 32001,
ssm_state=16.  Hymba uses sliding-window attention everywhere except the
first, middle and last layers (full attention), plus 128 learnable meta
tokens prepended to every sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    block_kind="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    conv_kernel=4,
    ssd_chunk=64,  # halves SSD score traffic (EXPERIMENTS §Perf H4)
    sliding_window=1024,
    full_attn_layers=(0, 16, 31),
    grad_accum=2,
    source="arXiv:2411.13676 (Hymba-1.5B)",
)

"""starcoder2-15b — GQA + RoPE + sliding window [arXiv:2402.19173].

40 layers, d_model=6144, 48 heads (GQA kv=4), d_ff=24576, vocab 49152.
StarCoder2 uses a 4096-token sliding window and biases => sub-quadratic
decode state, so long_500k RUNS for this arch (window ring-buffer cache).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    block_kind="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    sliding_window=4096,
    use_bias=True,
    act="gelu",
    glu=False,
    norm="layer",
    rope_theta=100_000.0,
    grad_accum=4,
    source="arXiv:2402.19173 (StarCoder2-15B)",
)

"""command-r-plus-104b — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

64 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab 256000.
Cohere blocks use parallel attention+FFN residual with a single LayerNorm
and tied embeddings.  Pure full attention => long_500k skipped (DESIGN.md
§4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    block_kind="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    parallel_residual=True,
    norm="layer",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
    grad_accum=8,
    kv_quant=True,  # int8 KV cache: decode_32k 18.2GB exceeds 16GB otherwise (EXPERIMENTS §Perf H3)  # 256-batch train does not fit otherwise (EXPERIMENTS §Perf)
    source="hf:CohereForAI/c4ai-command-r-v01 (scaled to R+ dims)",
)

"""smollm-360m — llama-architecture small model
[hf:HuggingFaceTB/SmolLM-135M family, 360M variant].

32 layers, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab 49152.
Pure full attention => long_500k skipped (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    block_kind="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

"""paligemma-3b — SigLIP + gemma decoder [arXiv:2407.07726].

Language/decoder backbone only: 18 layers, d_model=2048, 8 heads (GQA
kv=1, i.e. MQA), d_ff=16384, vocab 257216.  The SigLIP vision tower is a
STUB per the assignment: ``input_specs`` provides 256 precomputed patch
embeddings (1152-d SigLIP features) which the model projects and prepends
with a bidirectional prefix-LM mask.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    block_kind="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    n_patches=256,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    grad_accum=2,
    source="arXiv:2407.07726 (PaliGemma-3B / gemma-2b backbone)",
)

"""olmoe-1b-7b — 64 experts top-8, no shared experts [arXiv:2409.02060].

16 layers, d_model=2048, 16 heads (kv=16), per-expert d_ff=1024, vocab
50304.  OLMoE uses QK-norm and does NOT renormalize top-k router weights.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    block_kind="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    n_shared_experts=0,
    first_dense_layers=0,
    qk_norm=True,
    renorm_topk=False,
    grad_accum=2,
    source="arXiv:2409.02060 (OLMoE-1B-7B)",
)

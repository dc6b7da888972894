"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28 layers, d_model=2048, 16 heads (kv=16, i.e. MHA), per-expert d_ff=1408,
vocab 102400.  The first layer keeps a dense FFN (DeepSeekMoE design);
remaining 27 layers are MoE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    block_kind="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    grad_accum=4,
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
)

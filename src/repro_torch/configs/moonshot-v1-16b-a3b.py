"""moonshot-v1-16b-a3b — Moonlight (kimi), DeepSeek-V3-style MoE
[hf:moonshotai/Moonlight-16B-A3B].

48 layers, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408, vocab
163840, 64 routed experts top-6 with shared experts (16B total / ~3B
active).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    block_kind="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    grad_accum=4,
    kv_quant=True,  # int8 KV cache: decode_32k 23GB exceeds 16GB otherwise
    source="hf:moonshotai/Moonlight-16B-A3B",
)

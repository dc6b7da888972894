"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48 layers, d_model=2048, 4 heads, vocab 50304, d_ff=0 (the xLSTM block's
up-projection lives inside the mLSTM cell; no separate FFN).  The 1.3B
model in the paper is xLSTM[7:1]: one sLSTM block per 8 layers, the rest
mLSTM — expressed here as slstm_every=8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    block_kind="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    glu=False,
    tie_embeddings=False,
    grad_accum=4,
    act_shard=False,  # EXPERIMENTS §Perf H2: gathers from act-sharded carries dominate; accum=4 pays the memory instead
    source="arXiv:2405.04517 (xLSTM[7:1] 1.3B)",
)

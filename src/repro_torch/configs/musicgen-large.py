"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Transformer backbone only: 48 layers, d_model=2048, 32 heads (kv=32, MHA),
d_ff=8192, vocab 2048 per codebook.  The EnCodec audio codec is a STUB per
the assignment: inputs are 4 parallel codebook token streams (delay
pattern applied upstream); embeddings are summed, and 4 output heads
predict the next token of each codebook.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    block_kind="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    act="gelu",
    glu=False,
    norm="layer",
    use_bias=True,
    grad_accum=2,
    kv_quant=True,  # int8 KV cache: full-MHA decode_32k cache 23GB otherwise
    source="arXiv:2306.05284 (MusicGen-large)",
)

"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf].
LayerNorm + GELU, sinusoidal positions (no rope).  The EnCodec frontend is a
STUB per the brief: `input_specs()` provides precomputed frame embeddings
[B, S, d_model]; the config still owns the 4-codebook token embedding/output
head (vocab 2048 per codebook stream).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope="none",
    pos_embed="sinusoidal",
    norm="layernorm",
    act="gelu",
    frontend="encodec",
    n_codebooks=4,
)

"""starcoder2-15b [dense] — GQA kv=4, RoPE.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 [arXiv:2402.19173; hf].
LayerNorm + GELU MLP, attention biases on (starcoder2 uses bias=True).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope="standard",
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
)

"""chatglm3-6b [dense] — 2d/partial RoPE, GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793; hf].
RMSNorm, SwiGLU, rotary applied to half the head dim (the "RoPE 2d"
convention), QKV bias on.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="partial",
    rope_fraction=0.5,
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,
)

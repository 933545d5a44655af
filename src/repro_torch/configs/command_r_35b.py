"""command-r-35b [dense] — GQA, no biases.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified].  LayerNorm, SwiGLU-style
gate (Cohere uses parallel blocks; we keep sequential pre-norm residuals and
note the deviation — parameter shapes and FLOPs match).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope="standard",
    norm="layernorm",
    act="silu",
    qkv_bias=False,
    tie_embeddings=True,    # command-r ties input/output embeddings
)

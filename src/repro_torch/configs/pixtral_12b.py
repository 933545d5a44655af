"""pixtral-12b [vlm] — Pixtral-ViT frontend + Mistral-NeMo-style backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  The ViT patch-encoder is a
STUB per the brief: `input_specs()` provides precomputed patch/text
embeddings [B, S, d_model]; the decoder backbone (RMSNorm, SwiGLU, RoPE
theta=1e9-ish — we keep 1e6) is fully implemented.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    d_head=128,
    rope="standard",
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    frontend="vit",
)

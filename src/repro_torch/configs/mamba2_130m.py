"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified].
expand=2 => d_inner=1536, head_dim=64 => 24 SSD heads, conv width 4,
chunk 256.  Tied embeddings.  Sub-quadratic => long_500k applies.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,              # attention-free: unused
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
    rope="none",
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    sub_quadratic=True,
)

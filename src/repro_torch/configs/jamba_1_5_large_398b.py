"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts top-2
[arXiv:2403.19887 / Jamba-1.5; hf].  Period-8 blocks: one attention layer per
block (index 4), seven Mamba layers; MoE FFN every 2nd layer.  Jamba's Mamba
layers use d_state=16, conv=4, expand=2; we realize them with the Mamba2/SSD
formulation (head_dim 64).  Sub-quadratic => long_500k applies.
"""
from .base import HybridConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=24576),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk=256),
    hybrid=HybridConfig(period=8, attn_index=4, moe_every=2),
    rope="standard",
    norm="rmsnorm",
    act="silu",
    sub_quadratic=True,
)

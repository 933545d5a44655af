"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400 [arXiv:2405.04434; hf].
MLA kv_lora=512 (no q compression in Lite), qk_nope=128 qk_rope=64 v=128.
MoE: 64 routed experts top-6 + 2 shared, first layer dense (d_ff=10944).
(The assignment note "160 routed" describes V2-full; Lite is 64 routed.)
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: latent-shared; head count for layout only
    d_ff=10944,             # dense-prefix FFN width
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert_ff=1408,
                  n_dense_prefix=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    rope="standard",
    norm="rmsnorm",
    act="silu",
)

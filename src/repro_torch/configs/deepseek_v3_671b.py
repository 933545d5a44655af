"""deepseek-v3-671b [moe] — MLA + 256-expert MoE + sigmoid gating + MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280 [arXiv:2412.19437; hf].
MLA kv_lora=512, q_lora=1536, qk_nope=128 qk_rope=64 v=128.
MoE: 256 routed top-8 + 1 shared, sigmoid router with bias-based load
balance, routed_scaling 2.5; first 3 layers dense (d_ff=18432).  MTP head on.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # dense-prefix FFN width
    vocab_size=129280,
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert_ff=2048,
                  n_dense_prefix=3, router="sigmoid", router_scale=2.5),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    rope="standard",
    norm="rmsnorm",
    act="silu",
    mtp=True,
)

"""Architecture configuration schema (the port's own copy of
`repro/configs/base.py`: same fields, same defaults, same `reduced()`, and
the input shapes a cell runs, `shapes_for`)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # always-on shared experts
    d_expert_ff: int = 0           # per-expert FFN width (0 => use d_ff)
    layer_period: int = 1          # MoE every `period` layers...
    n_dense_prefix: int = 0        # ...after this many leading dense layers
    router: str = "softmax"        # "softmax" | "sigmoid" (deepseek-v3)
    capacity_factor: float = 1.25
    router_scale: float = 1.0      # routed_scaling_factor


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => no q compression (v2-lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    period: int = 8                # layers per repeating block
    attn_index: int = 4            # which layer in the block is attention
    moe_every: int = 2             # MoE FFN every k-th layer in the block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 => d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    rope: str = "standard"         # standard | partial | none
    pos_embed: str = "none"        # none | sinusoidal (absolute, musicgen)
    rope_fraction: float = 1.0     # partial rotary (chatglm: 0.5)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    tie_embeddings: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    frontend: Optional[str] = None  # encodec | vit (stub modality frontends)
    n_codebooks: int = 4            # encodec frontend
    mtp: bool = False               # deepseek-v3 multi-token prediction head
    sub_quadratic: bool = False     # supports long_500k decode
    max_seq_len: int = 1 << 20
    remat: str = "layer"            # layer | none — checkpoint scan bodies

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.hybrid is None else (self.hybrid.period)),
            d_model=128, n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            d_ff=256, vocab_size=512, d_head=32, max_seq_len=4096,
        )
        if self.moe is not None:
            small["moe"] = replace(self.moe, n_experts=min(8, self.moe.n_experts),
                                   top_k=min(2, self.moe.top_k),
                                   d_expert_ff=128 if self.moe.d_expert_ff else 0)
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=64,
                                     q_lora_rank=32 if self.mla.q_lora_rank else 0,
                                     qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.ssm is not None:
            small["ssm"] = replace(self.ssm, d_state=32, head_dim=32, chunk=32)
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[InputShape, ...]:
    """long_500k only for sub-quadratic (SSM/hybrid) architectures."""
    if cfg.sub_quadratic:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)

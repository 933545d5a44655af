"""Analytic parameter counts and MODEL_FLOPS per (arch x shape): the port's
copy of `repro/analysis/model_math.py` (no JAX there either; the port keeps
its own copy, reading `repro_torch.configs.base`).

MODEL_FLOPS convention (matches the roofline brief):
  train    : 6 x N_active x tokens     (fwd 2N + bwd 4N)
  prefill  : 2 x N_active x tokens
  decode   : 2 x N_active x batch      (one token per sequence)
attention-score FLOPs (context-dependent) are reported separately since the
6ND rule ignores them; at 32k+ they matter.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import InputShape, ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        q = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
             if m.q_lora_rank else d * cfg.n_heads * qk)
        kv = d * (m.kv_lora_rank + m.qk_rope_dim) \
            + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        o = cfg.n_heads * m.v_head_dim * d
        return q + kv + o
    dh = cfg.head_dim
    return d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 2 if cfg.act == "gelu" else 3  # wi/wo vs gate/up/down
    return mult * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig) -> Dict[str, int]:
    mo = cfg.moe
    ff = mo.d_expert_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * ff
    router = cfg.d_model * mo.n_experts
    shared = 3 * cfg.d_model * ff * mo.n_shared
    return {
        "total": mo.n_experts * per_expert + router + shared,
        "active": mo.top_k * per_expert + router + shared,
    }


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    h = di // s.head_dim
    in_p = cfg.d_model * (2 * di + 2 * gn + h)
    conv = s.d_conv * (di + 2 * gn)
    out_p = di * cfg.d_model
    return in_p + conv + out_p + 3 * h + di


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Returns {"total": N, "active": N_active} (embedding included once)."""
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    total = active = embed

    if cfg.family == "ssm":
        per = _ssm_params(cfg)
        total += cfg.n_layers * per
        active = total
        return {"total": total, "active": active}

    if cfg.family == "hybrid":
        hy = cfg.hybrid
        nb = cfg.n_layers // hy.period
        attn = _attn_params(cfg)
        ssm = _ssm_params(cfg)
        moe = _moe_params(cfg)
        n_moe = sum(1 for i in range(hy.period) if i % hy.moe_every == 1)
        n_dense = hy.period - n_moe
        per_block_total = attn + (hy.period - 1) * ssm \
            + n_moe * moe["total"] + n_dense * _mlp_params(cfg, cfg.d_ff)
        per_block_active = attn + (hy.period - 1) * ssm \
            + n_moe * moe["active"] + n_dense * _mlp_params(cfg, cfg.d_ff)
        return {"total": embed + nb * per_block_total,
                "active": embed + nb * per_block_active}

    attn = _attn_params(cfg)
    if cfg.moe is not None:
        mo = cfg.moe
        moe = _moe_params(cfg)
        n_moe = sum(1 for i in range(cfg.n_layers)
                    if i >= mo.n_dense_prefix
                    and (i - mo.n_dense_prefix) % mo.layer_period == 0)
        n_dense = cfg.n_layers - n_moe
        total += cfg.n_layers * attn + n_moe * moe["total"] \
            + n_dense * _mlp_params(cfg, cfg.d_ff)
        active += cfg.n_layers * attn + n_moe * moe["active"] \
            + n_dense * _mlp_params(cfg, cfg.d_ff)
    else:
        per = attn + _mlp_params(cfg, cfg.d_ff)
        total += cfg.n_layers * per
        active = total
    return {"total": total, "active": active}


def n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    return cfg.n_layers


def attention_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Score+value matmul FLOPs not captured by 6ND."""
    la = n_attn_layers(cfg)
    dh = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if cfg.mla else cfg.head_dim
    dv = cfg.mla.v_head_dim if cfg.mla else cfg.head_dim
    h = cfg.n_heads
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        # causal: s^2/2 per pair of (score, value) matmuls, x3 for fwd+bwd
        return 3.0 * la * b * h * (s * s) * (dh + dv)
    if shape.kind == "prefill":
        return 1.0 * la * b * h * (s * s) * (dh + dv)
    # decode: one query over s cache entries
    return 2.0 * la * b * h * s * (dh + dv)


def model_flops(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    n = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        base = 6.0 * n["active"] * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        base = 2.0 * n["active"] * tokens
    else:
        base = 2.0 * n["active"] * shape.global_batch
    att = attention_flops(cfg, shape)
    return {"model_flops": base, "attention_flops": att,
            "total": base + att, "n_total": n["total"],
            "n_active": n["active"]}

"""Core neural layers of the port (PyTorch, functional on dicts of tensors).

Counterpart of `repro/models/layers.py`, with the same names and layouts:
* params are nested dicts of tensors whose keys mirror the JAX pytree
  (`wq` [d,H,dh], `wo` [H,dh,d], ...), so a JAX leaf maps to one tensor;
* activations bf16, params bf16, all reductions and softmax in fp32;
* attention layouts: x [B, S, D]; q [B, S, H, dh]; kv [B, S, Hkv, dh];
  the KV cache is [L, B, T, Hkv, dh] in bf16.

The RMS norm, attention (train, prefill and decode) and, in the model's
loss, the cross-entropy go through the CUDA kernels on a CUDA tensor, and
through their plain versions on a CPU tensor (see `repro_torch.kernels`);
on the train path through autograd ops whose backward runs the backward
kernels.  The LayerNorm stays plain torch, as JAX computes it in jnp.
The activation-sharding constraints of `repro.context` are single-device
no-ops and have no counterpart here; MLA, MoE and the `embeds` frontends
are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, flash_attention_fwd
from ..kernels.rmsnorm import rmsnorm_op

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# init helpers: the JAX init's distributions, drawn from a torch.Generator
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, in_dim: int, device,
                dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def _zeros(shape, device, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.bfloat16, device=device),
                "bias": _zeros((d,), device)}
    return {"scale": torch.ones(d, dtype=torch.bfloat16, device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if "bias" in p:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    return rmsnorm_op(x, p["scale"], eps=eps)


# ---------------------------------------------------------------------------
# rotary embeddings (split-halves convention, as the JAX package)
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                 # [rot/2]
    ang = positions[..., None].float() * freqs               # [..., S, rot/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h, dh), d, device),
        "wk": _dense_init(gen, (d, hkv, dh), d, device),
        "wv": _dense_init(gen, (d, hkv, dh), d, device),
        "wo": _dense_init(gen, (h, dh, d), h * dh, device),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros((h, dh), device)
        p["bk"] = _zeros((hkv, dh), device)
        p["bv"] = _zeros((hkv, dh), device)
    return p


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, *, q_offset: int = 0,
                             q_chunk: int = 512) -> torch.Tensor:
    """Plain causal GQA attention over query chunks.

    q [B,Sq,H,dh]; k,v [B,T,Hkv,dh]; `q_offset` is the absolute position of
    q[0], and query i sees keys t <= q_offset + i.  The serve path runs the
    kernels instead; this is their reference in the model's layout.
    """
    b, sq, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        raise ValueError(f"q length {sq} is not a multiple of q_chunk {q_chunk}")
    kf, vf = k.float(), v.float()
    t_idx = torch.arange(t, device=q.device)
    dv = v.shape[-1]
    outs = []
    for c0 in range(0, sq, q_chunk):
        qc = q[:, c0:c0 + q_chunk].float().reshape(b, q_chunk, hkv, rep, dh)
        sc = torch.einsum("bsgrd,btgd->bgrst", qc, kf) * scale
        q_idx = q_offset + c0 + torch.arange(q_chunk, device=q.device)
        mask = t_idx[None, :] <= q_idx[:, None]
        sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
        w = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bgrst,btgd->bsgrd", w, vf).reshape(b, q_chunk, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, *,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos: Optional[int] = None):
    """Causal self-attention.  If `kv_cache` ({"k", "v"}: one layer's
    [B, T, Hkv, dh] bf16 slices) is given, x is the new token chunk and its
    keys and values are written into the cache at `cache_pos` IN PLACE (the
    JAX version returns an updated copy).  Returns (y, kv_cache)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope != "none":
        frac = cfg.rope_fraction if cfg.rope == "partial" else 1.0
        q = apply_rope(q, positions, cfg.rope_theta, frac)
        k = apply_rope(k, positions, cfg.rope_theta, frac)

    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = x.shape[1]
    if kv_cache is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale).transpose(1, 2)
    else:
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        if s == 1:
            lengths = torch.full((x.shape[0],), cache_pos + 1, dtype=torch.int32,
                                 device=x.device)
            out = decode_attention(q[:, 0], ck, cv, lengths, scale=scale)[:, None]
        else:
            # attend over the bf16 cache (as JAX reads it back), not k/v
            out, _ = flash_attention_fwd(
                q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
                scale=scale, q_offset=cache_pos, kv_len=cache_pos + s)
            out = out.transpose(1, 2)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, kv_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_attn_layers: int, device) -> Dict[str, torch.Tensor]:
    shape = (n_attn_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _zeros(shape, device), "v": _zeros(shape, device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "gelu":
        return {"wi": _dense_init(gen, (d, ff), d, device),
                "wo": _dense_init(gen, (ff, d), ff, device)}
    return {"wi_gate": _dense_init(gen, (d, ff), d, device),
            "wi_up": _dense_init(gen, (d, ff), d, device),
            "wo": _dense_init(gen, (ff, d), ff, device)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wi" in p:
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"]).float(),
                   approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h.to(x.dtype), p["wo"])
    g = F.silu(torch.einsum("bsd,df->bsf", x, p["wi_gate"]).float())
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"]).float()
    return torch.einsum("bsf,fd->bsd", (g * u).to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# embeddings / output head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p = {"tok": _dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                                device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["tok"])


def head_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output head's product in the params' dtype: what the fused
    cross-entropy reads (JAX casts it to fp32 first, which changes no value)."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, p["tok"])
    return torch.einsum("bsd,dv->bsv", h, p["head"])


def lm_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return head_logits(p, h, cfg).float()

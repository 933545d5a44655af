"""Model assembly of the port: the train and serve paths of the dense
transformer decoder, of the pure Mamba2 (ssm) stack, of the MoE family
(MLA attention, capacity-routed MoE, the dense prefix layers) and of the
hybrid (Jamba) family's period blocks, and the MTP head's params.

Counterpart of `repro/models/transformer.py`.  Ported so far: `init_model`,
`init_cache`, `_layer_is_moe`, `_init_tf_layer`, `_apply_tf_layer`,
`_init_hybrid_block`, `_apply_hybrid_layer`, `_apply_hybrid_block`,
`_model_step`, `_serve_tf`, `prefill` and `decode_step`, `forward`,
`_chunked_ce`, `loss_fn` and `_embed_inputs` for the dense, moe, ssm and
hybrid families and the stub-frontend (vlm, audio) ones: a batch may carry
a frontend's `embeds` [B, S, D] in place of the token embedding, and
sinusoidal positions are added where the config has them.  `forward` sums
the MoE layers' load-balancing aux loss, as JAX's does; `loss_fn` adds deepseek-v3-671b's
multi-token prediction (MTP) loss as JAX's does (ssm and hybrid have no MTP
branch, as in JAX).
A depth cut that keeps only the dense prefix leaves `params["blocks"]`
empty, which JAX's stacked `init_model` cannot build.  Layers are kept as
a list of per-layer param dicts (`params["blocks"][i]`, and the MoE family's dense
`params["prefix"][i]`, as JAX names them) where JAX stacks the blocks for
`lax.scan`, and the loop over layers is a Python loop; a hybrid model's
`params["blocks"][i]` is one period block, `{"layers": [period dicts]}`.
`jax.checkpoint` becomes `torch.utils.checkpoint` (non-reentrant): around
each layer (each whole period block of a hybrid model) when
`cfg.remat == "layer"`, and around each cross-entropy chunk always.
The activation constraints of `repro_torch.context` sit where JAX's do
(no-ops without a mesh); under a mesh the CE kernel runs on each rank's
rows through `local_map` (`_ce_sharded`), and the tensors the model makes
itself (positions' tables, the aux and CE zeros, the default mask) are
replicated DTensors beside DTensor activations.  `_tf_layer_axes`,
`_ssm_layer_axes` and `_hybrid_block_axes` give each layer's logical axes,
as JAX's `init_*` return them (`runtime.steps.model_axes` assembles them).

Public entry points (used by runtime/launch):
  init_model(cfg, gen, device)                 -> params
  loss_fn(params, batch, cfg)                  -> (loss, metrics)   [train]
  prefill(params, batch, cfg, cache)           -> (logits_last, cache)
  decode_step(params, batch, cfg, cache, pos)  -> (logits, cache)
  init_cache(cfg, batch, max_len, device)      -> cache
The cache (KV, MLA's latent and rotary keys, the ssm conv and scan
states, or a hybrid model's KV and conv and scan states of every block) is
updated in place and returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..context import constrain_bsd, keep_shards, recompute_kwargs, replicated
from ..kernels.cross_entropy import fused_ce_op
from ..tree import tree_leaves
from . import layers as L
from . import ssm as S

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# per-layer init/apply
# ---------------------------------------------------------------------------

def _layer_is_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    mo = cfg.moe
    if mo is None or layer_idx < mo.n_dense_prefix:
        return False
    return (layer_idx - mo.n_dense_prefix) % mo.layer_period == 0


def _init_tf_layer(cfg: ModelConfig, gen: torch.Generator, device, *,
                   moe: bool = False) -> Params:
    return {"attn_norm": L.init_norm(cfg, device),
            "attn": (L.init_mla(cfg, gen, device) if cfg.mla is not None
                     else L.init_attention(cfg, gen, device)),
            "ffn_norm": L.init_norm(cfg, device),
            "ffn": L.init_moe(cfg, gen, device) if moe else L.init_mlp(cfg, gen, device)}


def _tf_layer_axes(cfg: ModelConfig, *, moe: bool = False) -> Dict[str, Any]:
    return {"attn_norm": L.norm_axes(cfg),
            "attn": L.mla_axes(cfg) if cfg.mla is not None else L.attention_axes(cfg),
            "ffn_norm": L.norm_axes(cfg),
            "ffn": L.moe_axes(cfg) if moe else L.mlp_axes(cfg)}


def _apply_tf_layer(cfg: ModelConfig, p: Params, h: torch.Tensor, positions,
                    *, moe: bool = False, cache=None, cache_pos=None):
    """-> (h, new_cache, aux): aux is the MoE load-balancing loss, None
    after a dense FFN."""
    attn_in = L.apply_norm(p["attn_norm"], h)
    attn = L.mla_fwd if cfg.mla is not None else L.attention_fwd
    y, new_cache = attn(p["attn"], attn_in, cfg, positions, kv_cache=cache,
                        cache_pos=cache_pos)
    # the contraction's output takes the residual layout before the add
    h = h + constrain_bsd(y)
    ffn_in = L.apply_norm(p["ffn_norm"], h)
    if moe:
        y, aux = L.apply_moe(p["ffn"], ffn_in, cfg)
    else:
        y, aux = L.apply_mlp(p["ffn"], ffn_in, cfg), None
    return h + constrain_bsd(y), new_cache, aux


# ---------------------------------------------------------------------------
# ssm layer (pure mamba stack)
# ---------------------------------------------------------------------------

def _init_ssm_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {"norm": L.init_norm(cfg, device), "ssm": S.init_ssm(cfg, gen, device)}


def _ssm_layer_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": L.norm_axes(cfg), "ssm": S.ssm_axes(cfg)}


def _apply_ssm_layer(cfg: ModelConfig, p: Params, h: torch.Tensor, *, state=None):
    y, new_state = S.ssm_fwd(p["ssm"], L.apply_norm(p["norm"], h), cfg, state=state)
    return h + constrain_bsd(y), new_state


# ---------------------------------------------------------------------------
# hybrid (Jamba) period block
# ---------------------------------------------------------------------------

def _hybrid_moe(cfg: ModelConfig, i: int) -> bool:
    return i % cfg.hybrid.moe_every == 1


def _init_hybrid_block(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """{"layers": [period dicts]}, each with mixer_norm, mixer (attention at
    `attn_index`, a Mamba2 layer elsewhere), ffn_norm and ffn (MoE on every
    `moe_every`-th layer from 1, the dense MLP elsewhere)."""
    hy = cfg.hybrid
    layers = []
    for i in range(hy.period):
        mixer = (L.init_attention(cfg, gen, device) if i == hy.attn_index
                 else S.init_ssm(cfg, gen, device))
        layers.append({"mixer_norm": L.init_norm(cfg, device), "mixer": mixer,
                       "ffn_norm": L.init_norm(cfg, device),
                       "ffn": (L.init_moe(cfg, gen, device) if _hybrid_moe(cfg, i)
                               else L.init_mlp(cfg, gen, device))})
    return {"layers": layers}


def _hybrid_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    hy = cfg.hybrid
    return {"layers": [{"mixer_norm": L.norm_axes(cfg),
                        "mixer": (L.attention_axes(cfg) if i == hy.attn_index
                                  else S.ssm_axes(cfg)),
                        "ffn_norm": L.norm_axes(cfg),
                        "ffn": L.moe_axes(cfg) if _hybrid_moe(cfg, i) else L.mlp_axes(cfg)}
                       for i in range(hy.period)]}


def _apply_hybrid_layer(cfg: ModelConfig, lp: Params, i: int, h: torch.Tensor, positions,
                        *, kv_cache=None, state=None, cache_pos=None):
    """Layer i of a period block: its mixer (attention at `attn_index`,
    reading and writing `kv_cache` in place when given; a Mamba2 layer
    elsewhere, from `state` {"conv", "ssm"} or from zeros) and its FFN (MoE
    on every `moe_every`-th layer from 1), each after its norm and added to
    the residual.  Returns (h, aux, the Mamba layer's new state or None): aux
    is the layer's MoE load-balancing loss, 0 for a dense FFN."""
    x = L.apply_norm(lp["mixer_norm"], h)
    nst = None
    if i == cfg.hybrid.attn_index:
        y, _ = L.attention_fwd(lp["mixer"], x, cfg, positions, kv_cache=kv_cache,
                               cache_pos=cache_pos)
    else:
        y, nst = S.ssm_fwd(lp["mixer"], x, cfg, state=state)
    h = h + constrain_bsd(y)
    x = L.apply_norm(lp["ffn_norm"], h)
    if _hybrid_moe(cfg, i):
        y, aux = L.apply_moe(lp["ffn"], x, cfg)
    else:
        y, aux = L.apply_mlp(lp["ffn"], x, cfg), torch.zeros((), dtype=torch.float32,
                                                             device=h.device)
    return h + constrain_bsd(y), aux, nst


def _apply_hybrid_block(cfg: ModelConfig, p: Params, h: torch.Tensor, positions, *,
                        cache=None, cache_pos=None):
    """One period block, `_apply_hybrid_layer` a layer.  `cache` is this
    block's {"kv": {"k", "v"} [B, T, Hkv, dh], "conv": [period - 1, B, W-1,
    C], "ssm": [period - 1, B, H, P, N]} or None (the train path: attention
    through the flash kernels, every Mamba layer from a zero state).  With a
    cache the attention layer writes its keys and values in place and the
    Mamba layers' new states are copied into their slots.  Returns (h,
    cache, aux): aux is the sum of the block's MoE load-balancing losses."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ssm_i = 0
    for i, lp in enumerate(p["layers"]):
        st = None
        if cache is not None and i != cfg.hybrid.attn_index:
            st = {"conv": cache["conv"][ssm_i], "ssm": cache["ssm"][ssm_i]}
        h, a, nst = _apply_hybrid_layer(cfg, lp, i, h, positions,
                                        kv_cache=None if cache is None else cache["kv"],
                                        state=st, cache_pos=cache_pos)
        if st is not None:
            st["conv"].copy_(nst["conv"])
            st["ssm"].copy_(nst["ssm"])
        ssm_i += int(i != cfg.hybrid.attn_index)
        aux = aux + a
    return h, cache, aux


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights with the JAX init's distributions, drawn on `device`
    from `gen` (the numbers differ from `jax.random`'s).  The MoE family
    keeps its dense prefix layers in `prefix`, the rest in `blocks`, and
    deepseek-v3's multi-token-prediction head in `mtp`, as JAX names them.
    A hybrid model's `blocks` holds its n_layers // period period blocks."""
    params: Params = {"embed": L.init_embed(cfg, gen, device),
                      "final_norm": L.init_norm(cfg, device)}
    if cfg.family == "ssm":
        params["blocks"] = [_init_ssm_layer(cfg, gen, device) for _ in range(cfg.n_layers)]
        return params
    if cfg.family == "hybrid":
        params["blocks"] = [_init_hybrid_block(cfg, gen, device)
                            for _ in range(cfg.n_layers // cfg.hybrid.period)]
        return params
    n_prefix = cfg.moe.n_dense_prefix if cfg.moe else 0
    if n_prefix:
        params["prefix"] = [_init_tf_layer(cfg, gen, device) for _ in range(n_prefix)]
    params["blocks"] = [_init_tf_layer(cfg, gen, device, moe=_layer_is_moe(cfg, i))
                        for i in range(n_prefix, cfg.n_layers)]
    if cfg.mtp:      # deepseek-v3's multi-token-prediction head
        params["mtp"] = {"layer": _init_tf_layer(cfg, gen, device),
                         "norm": L.init_norm(cfg, device)}
    return params


# ---------------------------------------------------------------------------
# forward (train: full sequence, no cache) and loss
# ---------------------------------------------------------------------------

def _embed_inputs(params: Params, batch: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """The layers' input [B, S, D] bf16: a stub frontend's `embeds`, where the
    config has a frontend and the batch carries them, else the token
    embedding; plus sinusoidal positions from the batch's `pos0` (default 0)
    where the config has them, as JAX's `_embed_inputs`."""
    if cfg.frontend is not None and "embeds" in batch:
        h = batch["embeds"].to(torch.bfloat16)
    else:
        h = L.embed_tokens(params["embed"], batch["tokens"])
    if cfg.pos_embed == "sinusoidal":
        positions = batch.get("pos0", 0) + torch.arange(h.shape[1], device=h.device)
        h = h + replicated(L.sinusoidal_embed(positions, cfg.d_model), h)
    return h


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; returns (hidden [B,S,D], aux_loss).  The ssm
    stack runs each layer from no state, as JAX's forward does.  The MoE
    family runs its dense prefix layers, then its MoE blocks, and sums their
    aux losses: each checkpointed block returns its aux as an output, so its
    gradient flows.  The hybrid family does the same a period block at a
    time, each whole block checkpointed, as JAX's remat wraps its scanned
    block body."""
    h = constrain_bsd(_embed_inputs(params, batch, cfg))
    positions = torch.arange(h.shape[1], device=h.device)
    aux = replicated(torch.zeros((), dtype=torch.float32, device=h.device), h)

    def run(body, hh, lp):
        # activation checkpointing: backward recomputes each layer from its
        # input, so only the [B,S,D] carry per layer is kept
        return (checkpoint(body, hh, lp, use_reentrant=False, **recompute_kwargs())
                if cfg.remat == "layer" else body(hh, lp))

    if cfg.family == "ssm":
        def body(hh, lp):
            return constrain_bsd(_apply_ssm_layer(cfg, lp, hh)[0])
    else:
        def body(hh, lp):
            return constrain_bsd(_apply_tf_layer(cfg, lp, hh, positions)[0])

    def moe_body(hh, lp):
        hh, _, a = _apply_tf_layer(cfg, lp, hh, positions, moe=True)
        return constrain_bsd(hh), a

    def hybrid_body(hh, bp):        # a period block, its MoE layers' aux summed
        hh, _, a = _apply_hybrid_block(cfg, bp, hh, positions)
        return constrain_bsd(hh), a

    for lp in params.get("prefix", []):
        h = run(body, h, lp)
    for lp in params["blocks"]:
        if cfg.family == "hybrid":
            h, a = run(hybrid_body, h, lp)
            aux = aux + a
        elif cfg.moe is not None:
            h, a = run(moe_body, h, lp)
            aux = aux + a
        else:
            h = run(body, h, lp)
    return constrain_bsd(L.apply_norm(params["final_norm"], h)), aux


def _chunked_ce(embed_params: Params, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, cfg: ModelConfig, n_chunks: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materialising the full [B,S,V] logits: the
    sequence is processed in recomputed chunks (peak memory = one chunk of
    bf16 logits; backward recomputes them).  Where a mesh splits h's
    sequence, a chunk takes its rows from every rank's piece, so it stays
    split and each rank runs the head and the CE on its own tokens (a slice
    across the pieces would gather the chunk onto every rank).  Returns
    (sum_nll, sum_mask)."""
    b, s, d = h.shape
    pieces = (math.prod(h.device_mesh.size(i) for i, p in enumerate(h.placements)
                        if p.is_shard(1)) if isinstance(h, DTensor) else 1)
    while (s // pieces) % n_chunks:
        n_chunks -= 1
    cs = s // pieces // n_chunks

    def chunk_nll(hc, lc, mc):
        logits = L.head_logits(embed_params, hc, cfg)        # [B,cs,V]
        if isinstance(logits, DTensor):
            return _ce_sharded(logits, lc, mc)
        return _ce_rows(logits, lc, mc)

    if pieces > 1:
        mesh, pl = h.device_mesh, list(h.placements)
        rows = [t if list(t.placements) == pl else t.redistribute(mesh, pl)
                for t in (h, labels, mask)]

        def chunk(t, c):
            return local_map(lambda a: a[:, c * cs:(c + 1) * cs], out_placements=pl,
                             in_placements=(pl,), device_mesh=mesh)(t)
    else:
        rows = (h, labels, mask)

        def chunk(t, c):
            return t[:, c * cs:(c + 1) * cs]

    total = replicated(torch.zeros((), dtype=torch.float32, device=h.device), h)
    for c in range(n_chunks):
        total = total + checkpoint(chunk_nll, *(chunk(t, c) for t in rows),
                                   use_reentrant=False)
    return total, mask.sum()


def _ce_rows(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return fused_ce_op(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                       mask.reshape(-1))


def _ce_sharded(logits: DTensor, labels: DTensor, mask: DTensor) -> DTensor:
    """The CE op on each rank's rows: logits [B, cs, V] keep their batch
    and sequence splits and are gathered whole over the vocab (the table
    shards it over "model"); labels and mask take the same placements.
    Each rank's masked NLL sum is a partial sum on the mesh dims that split
    the rows."""
    mesh = logits.device_mesh
    pl = keep_shards(logits, (0, 1))
    out = [Partial() if isinstance(p, Shard) else p for p in pl]
    fn = local_map(_ce_rows, out_placements=out, in_placements=(pl, pl, pl),
                   device_mesh=mesh)
    return fn(*(t.redistribute(mesh, pl) for t in (logits, labels, mask)))


def _shift_left(t: DTensor) -> DTensor:
    """t [B, S] one position to the left, a zero at the end, at t's
    placements (its sequence gathered for the shift: labels and a mask)."""
    whole = L._seq_whole(t)
    shifted = torch.cat([whole[:, 1:], torch.zeros_like(whole[:, :1])], dim=1)
    return L._placed(shifted, list(t.placements))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, aux_weight: float = 0.01, ce_chunks: int = 8
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens, labels [B,S] int64 and loss_mask [B,S] fp32 (optional)
    -> (loss, {loss, ce, aux, ppl}, and mtp_ce with an MTP head).

    The MTP head (deepseek-v3-671b) predicts the token after the label: one
    more dense layer and its norm on `forward`'s final-normed h, then the
    chunked CE of its first S - 1 positions against labels shifted by one,
    0.1 x that CE added to the loss, as JAX's `loss_fn`.  The layer is not
    checkpointed (JAX's is not); its CE chunks are, as the main loss's.
    Under a mesh it reads all S positions against the labels shifted by one
    with the last position masked (the same sum: `_shift_left`)."""
    h, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = replicated(torch.ones(labels.shape, dtype=torch.float32,
                                     device=labels.device), labels)
    nll_sum, msum = _chunked_ce(params["embed"], h, labels, mask, cfg,
                                n_chunks=ce_chunks)
    ce = nll_sum / torch.clamp(msum, min=1.0)
    loss = ce + aux_weight * aux
    metrics = {"loss": loss, "ce": ce, "aux": aux,
               "ppl": torch.exp(torch.clamp(ce, max=20.0))}
    if cfg.mtp and cfg.family not in ("ssm", "hybrid"):
        positions = torch.arange(h.shape[1], device=h.device)
        hm, _, _ = _apply_tf_layer(cfg, params["mtp"]["layer"], h, positions)
        hm = L.apply_norm(params["mtp"]["norm"], hm)
        if isinstance(hm, DTensor):
            # every position against the label after its own, the last one
            # masked: a split sequence stays split (a slice of it would be
            # gathered onto every rank)
            labels2, mask2 = _shift_left(labels), _shift_left(mask)
        else:
            hm, labels2, mask2 = hm[:, :-1], labels[:, 1:], mask[:, 1:]
        nll2, m2sum = _chunked_ce(params["embed"], hm, labels2, mask2, cfg,
                                  n_chunks=ce_chunks)
        mtp_ce = nll2 / torch.clamp(m2sum, min=1.0)
        loss = loss + 0.1 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    """KV cache {"kv": {"k", "v"}} [L,B,max_len,Hkv,dh]; with MLA the latent
    cache {"mla": {"ckv": [L,B,max_len,kv_lora], "krope": [L,B,max_len,rope]}}
    (the dense prefix layers' slots first); for ssm the conv and scan states
    ({"ssm_state": {"conv": [L,B,W-1,C] bf16, "ssm": [L,B,H,P,N] fp32}}),
    whose size does not depend on max_len; for hybrid, per period block the
    attention layer's KV and the Mamba layers' states, as JAX stacks them:
    {"kv": {"k", "v"} [NB,B,max_len,Hkv,dh], "conv": [NB,period-1,B,W-1,C],
    "ssm": [NB,period-1,B,H,P,N]}."""
    if cfg.family == "ssm":
        return {"ssm_state": S.init_ssm_state(cfg, batch, cfg.n_layers, device)}
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        nb = cfg.n_layers // hy.period
        st = S.init_ssm_state(cfg, batch, nb * (hy.period - 1), device)
        return {"kv": L.init_kv_cache(cfg, batch, max_len, nb, device),
                **{k: v.view(nb, hy.period - 1, *v.shape[1:]) for k, v in st.items()}}
    if cfg.mla is not None:
        return {"mla": L.init_mla_cache(cfg, batch, max_len, cfg.n_layers, device)}
    return {"kv": L.init_kv_cache(cfg, batch, max_len, cfg.n_layers, device)}


def _model_step(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                cache: Dict[str, Any], cache_pos
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Shared incremental forward for prefill (s>1) and decode (s=1); the
    sinusoidal positions start at `cache_pos` (a host int, or a decode
    step's 0-d int64 device tensor: the positions are int64 either way, so
    the rotary and sinusoidal angles are the same bits)."""
    if cfg.pos_embed == "sinusoidal":
        batch = dict(batch, pos0=cache_pos)
    h = constrain_bsd(_embed_inputs(params, batch, cfg))
    s = h.shape[1]
    positions = cache_pos + torch.arange(s, device=h.device)
    if cfg.family == "ssm":
        h, new_cache = _serve_ssm(params, h, cfg, cache["ssm_state"]), cache
    elif cfg.family == "hybrid":
        h, new_cache = _serve_hybrid(params, h, cfg, cache, cache_pos, positions), cache
    else:
        key = "mla" if cfg.mla is not None else "kv"
        h, nc = _serve_tf(params, h, cfg, cache[key], cache_pos, positions)
        new_cache = {key: nc}
    h = L.apply_norm(params["final_norm"], h)
    logits = L.lm_logits(params["embed"], h[:, -1:], cfg)
    return logits, new_cache


def _serve_ssm(params, h, cfg, states):
    """Mamba2 serve path: every layer reads its slice of the stacked [L, ...]
    conv and scan states and writes the new ones back in place."""
    for i, lp in enumerate(params["blocks"]):
        st = {"conv": states["conv"][i], "ssm": states["ssm"][i]}
        h, nst = _apply_ssm_layer(cfg, lp, h, state=st)
        h = constrain_bsd(h)
        st["conv"].copy_(nst["conv"])
        st["ssm"].copy_(nst["ssm"])
    return h


def _serve_hybrid(params, h, cfg, cache, cache_pos, positions):
    """Hybrid serve path: every period block reads its slice of the stacked
    [NB, ...] KV and conv and scan states and writes the new ones in place."""
    for i, bp in enumerate(params["blocks"]):
        bc = {"kv": {name: c[i] for name, c in cache["kv"].items()},
              "conv": cache["conv"][i], "ssm": cache["ssm"][i]}
        h, _, _ = _apply_hybrid_block(cfg, bp, h, positions, cache=bc, cache_pos=cache_pos)
        h = constrain_bsd(h)
    return h


def _serve_tf(params, h, cfg, cache, cache_pos, positions):
    """Transformer serve path: the dense prefix layers, then the blocks
    (MoE FFNs when the config has MoE); every layer reads and writes its
    slice of the stacked [L, ...] cache in place, the prefix's slots first."""
    layers = ([(lp, False) for lp in params.get("prefix", [])]
              + [(lp, cfg.moe is not None) for lp in params["blocks"]])
    for i, (lp, moe) in enumerate(layers):
        layer_cache = {name: c[i] for name, c in cache.items()}
        h, _, _ = _apply_tf_layer(cfg, lp, h, positions, moe=moe, cache=layer_cache,
                                  cache_pos=cache_pos)
        h = constrain_bsd(h)
    return h, cache


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    return _model_step(params, batch, cfg, cache, 0)


def decode_step(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                cache: Dict[str, Any], pos) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token step against a cache filled up to `pos`: a host int or a
    0-d integer tensor on the cache's device, as JAX traces its
    `jnp.int32`.  Without a mesh an int becomes such a tensor
    (`layers.device_pos`) and a tensor is never read back, so every position
    runs the same ops on the same shapes: one captured step replays for all
    of them.  A cache of DTensors (under a mesh) keeps its host int
    positions and its sharded paths."""
    leaf = tree_leaves(cache)[0]
    if not isinstance(leaf, DTensor):
        pos = L.device_pos(pos, leaf.device)
    return _model_step(params, batch, cfg, cache, pos)

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
MLA's absorbed attention and the MoE router, dispatch, expert products and
combine stay plain torch too: JAX computes them in jnp, with no Pallas
kernel.  MLA's expanded (no-cache) branch, the train path, attends through
the flash kernels at q/k head dim qk_nope + qk_rope against v head dim
v_head_dim, where JAX runs `blocked_causal_attention` (jnp): the port puts
a kernel there, as for the dense family.

Each `init_*` has an `*_axes(cfg)` beside it that gives the logical axes
of every leaf, JAX's tuples (its `init_*` returns them with the params),
which `runtime.sharding` maps to mesh axes.  The activation constraints of
`repro_torch.context` sit where JAX's do; they are no-ops unless the
activations are DTensors and specs are installed.  Under a mesh the kernels
run on each rank's local shard through `local_map` (`_rmsnorm_sharded`,
`_flash_sharded`, `_decode_sharded`, `_prefill_cached_sharded`): a kernel
wrapper reads `data_ptr` and cannot take a DTensor.  A cache of DTensors (at
`runtime.sharding.cache_specs`) is written in place by each rank at its own
rows (`_cache_write`), never gathered for a write.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..context import constrain, constrain_heads, constrain_kv, keep_shards, replicated
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, flash_attention_fwd
from ..kernels.rmsnorm import rmsnorm_op
from ..runtime.sharding import product_plan

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Any]

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


def norm_axes(cfg: ModelConfig) -> Axes:
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if "bias" in p:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    if isinstance(x, DTensor):
        return _rmsnorm_sharded(x, p["scale"], eps)
    return rmsnorm_op(x, p["scale"], eps=eps)


def _rmsnorm_sharded(x: DTensor, scale: DTensor, eps: float) -> DTensor:
    """The RMSNorm op on each rank's rows: x keeps its row shards (D
    whole), scale is gathered whole; the local dscale is a partial sum on
    the mesh dims that split the rows."""
    mesh = x.device_mesh
    pl = keep_shards(x, range(x.ndim - 1))
    rep_ = [Replicate()] * mesh.ndim
    fn = local_map(lambda a, s: rmsnorm_op(a, s, eps=eps), out_placements=pl,
                   in_placements=(pl, rep_), device_mesh=mesh,
                   in_grad_placements=(pl, [Partial() if isinstance(p, Shard) else p
                                            for p in pl]))
    return fn(x.redistribute(mesh, pl), scale.redistribute(mesh, rep_))


# ---------------------------------------------------------------------------
# rotary / positional embeddings (split-halves rotary, as the JAX package)
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
    cos, sin = replicated(cos, x), replicated(sin, x)
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal positions [..., d] in bf16: fp32 angles, the sin
    half then the cos half, as JAX's `sinusoidal_embed`."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(torch.bfloat16)


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


def attention_axes(cfg: ModelConfig) -> Axes:
    a = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        a.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    return a


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
    JAX version returns an updated copy).  A cache of DTensors takes the
    sharded path: `_cache_write`, then `_decode_sharded` or
    `_prefill_cached_sharded`.  Returns (y, kv_cache)."""
    wk, wv = p["wk"], p["wv"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias else (None, None)
    x_kv = x
    if isinstance(x, DTensor):
        # the sequence-parallel gather before the head projections (as
        # Megatron's): x keeps its batch split only, so the projections
        # split the heads over "model" (`_product`) rather than run each
        # rank's tokens against whole weights
        x = _placed(x, keep_shards(x, (0,)))
        # where the kv heads are too few to split with the query heads:
        # without a cache each rank projects only the kv heads its query
        # heads read; a cache (then split by its sequence) takes the keys
        # and values of each rank's own tokens, where x splits them
        few_kv = _kv_heads_whole(p["wq"], wk)
        if few_kv and kv_cache is None:
            wk, wv = _kv_weight(wk, p["wq"], 1), _kv_weight(wv, p["wq"], 1)
            if cfg.qkv_bias:
                bk, bv = _kv_weight(bk, p["wq"], 0), _kv_weight(bv, p["wq"], 0)
        if not (few_kv and kv_cache is not None and _sequence_split(x_kv)):
            x_kv = x
    q = _product("bsd,dhk->bshk", x, p["wq"])
    k = _product("bsd,dhk->bshk", x_kv, wk)
    v = _product("bsd,dhk->bshk", x_kv, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    if cfg.rope != "none":
        frac = cfg.rope_fraction if cfg.rope == "partial" else 1.0
        q = apply_rope(q, positions, cfg.rope_theta, frac)
        k = apply_rope(k, positions, cfg.rope_theta, frac)

    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = x.shape[1]
    if kv_cache is None:
        # the seq -> heads transition for the attention interior
        q, k, v = constrain_heads(q), constrain_kv(k), constrain_kv(v)
        out = constrain_heads(_flash(q, k, v, scale))
    elif isinstance(kv_cache["k"], DTensor):
        ck, cv = kv_cache["k"], kv_cache["v"]
        _cache_write(ck, k, cache_pos)
        _cache_write(cv, v, cache_pos)
        if s == 1:
            out = _decode_sharded(q[:, 0], ck, cv, cache_pos + 1, scale)[:, None]
        else:
            out = _prefill_cached_sharded(q, ck, cv, cache_pos, scale)
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
    y = _product("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, kv_cache


def _product(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum(eq, x, w) of an activation x and a weight w; under a mesh both
    are placed first by `sharding.product_plan`.  A row-parallel product's
    local partial products are fp32 results of the bf16 operands, summed in
    fp32 (reduced into the residual's "bsd" layout, or all-reduced where no
    spec splits it) and rounded to x's dtype once, as the unsharded product
    rounds (DTensor would round each partial first).  Where x's sequence is
    split, `_token_product`.  A plain x takes the plain einsum."""
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    if _sequence_split(x):
        return _token_product(eq, x, w)
    mesh = x.device_mesh
    plan = product_plan(eq, tuple(x.placements), tuple(w.placements),
                        tuple(mesh.size(i) for i in range(mesh.ndim)), tuple(x.shape),
                        tuple(w.shape), w.element_size())
    x, w = _placed(x, plan.x), _placed(w, plan.w)
    if not plan.row:
        return torch.einsum(eq, x, w)
    y = local_map(lambda a, b: _einsum_f32(eq, a, b), out_placements=list(plan.out),
                  in_placements=(list(plan.x), list(plan.w)),
                  in_grad_placements=(list(plan.x_grad), list(plan.w_grad)),
                  device_mesh=mesh)(x, w)
    y = constrain(y, "bsd")
    y = y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in y.placements])
    return y.to(x.dtype)


class _MmF32(torch.autograd.Function):
    """a @ b with an fp32 result of bf16 operands, rounded nowhere:
    `torch.mm`'s `out_dtype` on the card; the CPU has no such kernel, so
    there the operands are widened first (the same values).  The gradients
    are products in the operands' dtype, as the unsplit product's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.t(), a.t() @ g


def _einsum_f32(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum(eq, x, w) in fp32 by `_MmF32`, for an `eq` whose output is x's
    kept dims then w's (every product of the model's)."""
    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    kept, con = [c for c in xs if c not in ws], [c for c in xs if c in ws]
    wo = [c for c in ws if c not in xs]
    assert out == "".join(kept + wo), eq
    xm = x.permute([xs.index(c) for c in kept + con])
    wm = w.permute([ws.index(c) for c in con + wo])
    lead, tail = xm.shape[:len(kept)], wm.shape[len(con):]
    y = _MmF32.apply(xm.reshape(math.prod(lead), -1), wm.reshape(-1, math.prod(tail)))
    return y.reshape(*lead, *tail)


def _placed(t: DTensor, pl) -> DTensor:
    """`t` redistributed to `pl`, or `t` itself where they differ on no mesh
    dim larger than 1 (a placement there moves nothing, and DTensor's
    redistribute costs host time on every call)."""
    mesh = t.device_mesh
    if all(p == q or mesh.size(i) == 1 for i, (p, q) in enumerate(zip(t.placements, pl))):
        return t
    return t.redistribute(mesh, pl)


def _kv_heads_whole(wq: torch.Tensor, wk: torch.Tensor) -> bool:
    """Whether a mesh dim (of size > 1) splits wq's query heads [d, H, dh]
    but not wk's kv heads [d, Hkv, dh] (they do not divide it)."""
    if not isinstance(wq, DTensor):
        return False
    mesh = wq.device_mesh
    return any(mesh.size(i) > 1 and p == Shard(1) and q != Shard(1)
               for i, (p, q) in enumerate(zip(wq.placements, wk.placements)))


def _kv_weight(w: DTensor, wq: DTensor, hdim: int) -> DTensor:
    """w, a kv projection [d, Hkv, dh] (or its bias [Hkv, dh]: the heads at
    `hdim`) whole on a mesh dim that splits wq's query heads, as the
    projection of the kv heads each rank's query heads read: Megatron's
    duplication of kv heads, a split of (ranks x heads a rank) heads whose
    part on each rank is a slice of its own w, with no copy moved.  Its
    gradient is a partial sum over those dims.  `w` itself where a rank's
    query heads straddle two kv groups."""
    mesh, h, hkv = wq.device_mesh, wq.shape[1], w.shape[hdim]
    (h0, hl), rep = _local_rows(wq, 1), h // hkv
    if rep % hl and hl % rep:
        return w
    lo, c = h0 // rep, max(1, hl // rep)
    dup = [mesh.size(i) > 1 and p == Shard(1) for i, p in enumerate(wq.placements)]
    out = [Shard(hdim) if d else p for d, p in zip(dup, w.placements)]
    grad = [Partial() if d else p for d, p in zip(dup, w.placements)]
    return local_map(lambda t: t.narrow(hdim, lo, c), out_placements=out,
                     in_placements=(list(w.placements),), in_grad_placements=(grad,),
                     device_mesh=mesh)(w)


def _sequence_split(x: torch.Tensor) -> bool:
    """Whether x [B, S, ...] is a DTensor whose sequence dim is split."""
    return isinstance(x, DTensor) and any(p.is_shard(1) for p in x.placements)


def _token_product(eq: str, x: DTensor, w: DTensor) -> DTensor:
    """einsum(eq, x, w) on each rank's tokens: x [B, S, ...] keeps its batch
    and sequence splits, w is gathered whole (its FSDP and tensor-parallel
    splits), so the product's other dims are whole on every rank, JAX's
    token-sharded layout ("bsf").  w's local gradient is a partial sum over
    the mesh dims that split the tokens.  Where x's batch and sequence are
    both split, DTensor's own einsum flattens them into one dim, which it
    cannot always split again (torch 2.11 refuses)."""
    mesh = x.device_mesh
    xpl = keep_shards(x, (0, 1))
    rep = [Replicate()] * mesh.ndim
    wgrad = [Partial() if isinstance(p, Shard) else Replicate() for p in xpl]
    fn = local_map(lambda a, b: torch.einsum(eq, a, b), out_placements=xpl,
                   in_placements=(xpl, rep), in_grad_placements=(xpl, wgrad), device_mesh=mesh)
    return fn(x.redistribute(mesh, xpl), w.redistribute(mesh, rep))


def _flash_bshd(q, k, v, scale):
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           scale).transpose(1, 2)


def _flash(q, k, v, scale):
    """Causal flash attention in the model's layout (q [B,S,H,dh], k and v
    [B,S,Hkv,dh]), differentiable."""
    if isinstance(q, DTensor):
        return _flash_sharded(q, k, v, scale)
    return _flash_bshd(q, k, v, scale)


def _attention_placements(q: DTensor, k: DTensor, v: DTensor) -> Tuple[list, list, list]:
    """(q's, k and v's, k and v's gradient's) placements for attention on
    each rank's shard.  A mesh dim keeps a batch split where all three have
    one.  It keeps q's head split where q's heads divide it, k's and v's
    where theirs divide it too and are split, else k and v are whole on it
    and each rank attends with the kv heads its query heads read (GQA's
    tensor parallelism; their gradients are then partial sums), as long as
    a rank's query heads fill one kv group or whole groups.  Every other
    mesh dim, a sequence split among them, is gathered, as the causal mask
    needs the whole sequence."""
    mesh, h, hkv = q.device_mesh, q.shape[2], k.shape[2]
    qpl, kvpl, grad = [], [], []
    split = 1
    for i, (a, b, c) in enumerate(zip(q.placements, k.placements, v.placements)):
        n = mesh.size(i)
        if a == b == c == Shard(0):
            kv = g = a
        elif a == Shard(2) and h % (split * n) == 0:
            split *= n
            kv = a if b == c == a and hkv % n == 0 else Replicate()
            g = kv if kv == a else Partial()
        else:
            a = kv = g = Replicate()
        qpl.append(a), kvpl.append(kv), grad.append(g)
    rep, local = h // hkv, h // split
    if rep % local and local % rep:            # a rank's heads would straddle two groups
        qpl, kvpl, grad = ([Replicate() if p == Shard(2) else p for p in pl]
                           for pl in (qpl, kvpl, kvpl))
    return qpl, kvpl, grad


def _kv_heads(q: DTensor, k: DTensor) -> Tuple[int, int]:
    """(offset, count) of the kv heads, in k's local part, that the query
    heads of q's local part read."""
    (h0, hl), (k0, _) = _local_rows(q, 2), _local_rows(k, 2)
    rep = q.shape[2] // k.shape[2]
    return h0 // rep - k0, max(1, hl // rep)


def _attention_args(q: DTensor, k: DTensor, v: DTensor):
    """q, k and v at `_attention_placements`, the placements, and a
    function that cuts a rank's local k or v to the kv heads its local q
    reads (itself where it reads them all)."""
    mesh = q.device_mesh
    qpl, kvpl, grad = _attention_placements(q, k, v)
    q, k, v = q.redistribute(mesh, qpl), k.redistribute(mesh, kvpl), v.redistribute(mesh, kvpl)
    lo, n = _kv_heads(q, k)
    n_local = _local_rows(k, 2)[1]

    def heads(t):
        return t if (lo, n) == (0, n_local) else t[:, :, lo:lo + n]
    return (q, k, v), (qpl, kvpl, grad), heads


def _flash_sharded(q: DTensor, k: DTensor, v: DTensor, scale) -> DTensor:
    """The flash op on each rank's shard, at `_attention_placements`.  dq,
    dk and dv are exact on each shard (dk and dv partial sums over the
    ranks that share a kv head)."""
    args, (qpl, kvpl, grad), heads = _attention_args(q, k, v)
    fn = local_map(lambda a, b, c: _flash_bshd(a, heads(b), heads(c), scale),
                   out_placements=qpl, in_placements=(qpl, kvpl, kvpl),
                   in_grad_placements=(qpl, grad, grad), device_mesh=q.device_mesh)
    return fn(*args)


def _local_rows(t: DTensor, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's part of `t`'s dim `dim`, split in
    mesh-dim order by each `Shard(dim)` as `torch.chunk` splits (DTensor's
    even sharding: chunks of ceil(n / size), the last ones short or empty).
    DTensor's own `compute_local_shape_and_global_offset` reads index
    tensors back to the host, which fails on the dry run's fake tensors."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    off, n = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            size = -(-n // mesh.size(i))
            start = min(coord[i] * size, n)
            off, n = off + start, min(size, n - start)
    return off, n


def _cache_write(cache: DTensor, new: DTensor, pos: int) -> None:
    """new [B, s, Hkv, dh] into one layer's cache [B, T, Hkv, dh] at rows
    pos .. pos + s, in place: each rank writes the rows of its own part of
    the sequence, the rest of the cache untouched, and nothing of the cache
    moves.  `new` takes the cache's batch and head splits; on a mesh dim
    that splits the cache's sequence it stays split only where its rows
    line up with the cache's (pos 0, s = T), else each rank gets it whole."""
    mesh, s = cache.device_mesh, new.shape[1]
    pl = [p if not p.is_shard(1) else
          (p if q == p and pos == 0 and s == cache.shape[1] else Replicate())
          for p, q in zip(cache.placements, new.placements)]
    new = new.to(cache.dtype).redistribute(mesh, pl)
    c0, cn = _local_rows(cache, 1)
    n0, nn = _local_rows(new, 1)

    def write(c, n):
        lo, hi = max(pos + n0, c0), min(pos + n0 + nn, c0 + cn)
        if lo < hi:
            c[:, lo - c0:hi - c0] = n[:, lo - pos - n0:hi - pos - n0]
    local_map(write, out_placements=None, in_placements=(cache.placements, pl),
              device_mesh=mesh)(cache, new)


def _decode_sharded(q: DTensor, ck: DTensor, cv: DTensor, length: int, scale) -> DTensor:
    """Decode attention of q [B,H,dh] against the first `length` rows of a
    cache [B,T,Hkv,dh] of DTensors: each rank runs the kernel over its own
    rows, the lengths clipped to its part of the sequence.  q takes the
    cache's batch and kv-head splits and is whole on a mesh dim that splits
    the cache's sequence; there each rank's (out, lse) partial is gathered
    ([n, B, H, dh] and [n, B, H] fp32, never the cache) and merged by
    log-sum-exp, then rounded once, as the unsplit kernel rounds.  With no
    sequence split the kernel's output is the answer."""
    mesh = ck.device_mesh
    qpl = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate()
           for p in ck.placements]
    split = [p.is_shard(1) for p in ck.placements]
    c0, cn = _local_rows(ck, 1)
    n_local = min(max(length - c0, 0), cn)

    def attend(qq, kk, vv):
        lens = torch.full((qq.shape[0],), n_local, dtype=torch.int32, device=qq.device)
        if not any(split):
            return decode_attention(qq, kk, vv, lens, scale=scale)
        out, lse = decode_attention(qq, kk, vv, lens, scale=scale, return_lse=True)
        return out[None], lse[None]

    args = (q.redistribute(mesh, qpl), ck, cv)
    inp = (qpl, ck.placements, cv.placements)
    if not any(split):
        return local_map(attend, out_placements=qpl, in_placements=inp, device_mesh=mesh)(*args)
    part = [Shard(0) if sp else Shard(p.dim + 1) if p.is_shard() else p
            for p, sp in zip(qpl, split)]
    outs, lses = local_map(attend, out_placements=(part, part), in_placements=inp,
                           device_mesh=mesh)(*args)
    whole = [Replicate() if sp else p for p, sp in zip(part, split)]
    outs, lses = outs.redistribute(mesh, whole), lses.redistribute(mesh, whole)
    lse = torch.logsumexp(lses, dim=0)
    w = torch.exp(lses - lse)                                  # 0 where a part is empty
    return (w[..., None] * outs).sum(0).to(q.dtype)


def _prefill_cached_sharded(q: DTensor, ck: DTensor, cv: DTensor, pos: int, scale) -> DTensor:
    """The flash forward of q [B,s,H,dh] at positions pos .. pos + s against
    the cache's first pos + s rows, on each rank's shard at
    `_attention_placements` (a sequence split of the cache is gathered, the
    query heads kept split)."""
    s = q.shape[1]
    args, (qpl, kvpl, _), heads = _attention_args(q, ck, cv)

    def attend(qq, kk, vv):
        out, _ = flash_attention_fwd(qq.transpose(1, 2), heads(kk).transpose(1, 2),
                                     heads(vv).transpose(1, 2), scale=scale, q_offset=pos,
                                     kv_len=pos + s)
        return out.transpose(1, 2)
    return local_map(attend, out_placements=qpl, in_placements=(qpl, kvpl, kvpl),
                     device_mesh=ck.device_mesh)(*args)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_attn_layers: int, device) -> Dict[str, torch.Tensor]:
    shape = (n_attn_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _zeros(shape, device), "v": _zeros(shape, device)}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    p: Params = {}
    if m.q_lora_rank:
        p["wq_a"] = _dense_init(gen, (d, m.q_lora_rank), d, device)
        p["q_norm"] = torch.ones(m.q_lora_rank, dtype=torch.bfloat16, device=device)
        p["wq_b"] = _dense_init(gen, (m.q_lora_rank, h, qk), m.q_lora_rank, device)
    else:
        p["wq"] = _dense_init(gen, (d, h, qk), d, device)
    p["wkv_a"] = _dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_dim), d, device)
    p["kv_norm"] = torch.ones(m.kv_lora_rank, dtype=torch.bfloat16, device=device)
    p["wk_b"] = _dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_dim), m.kv_lora_rank, device)
    p["wv_b"] = _dense_init(gen, (m.kv_lora_rank, h, m.v_head_dim), m.kv_lora_rank, device)
    p["wo"] = _dense_init(gen, (h, m.v_head_dim, d), h * m.v_head_dim, device)
    return p


def mla_axes(cfg: ModelConfig) -> Axes:
    if cfg.mla.q_lora_rank:
        a = {"wq_a": ("embed", "lora"), "q_norm": ("lora",),
             "wq_b": ("lora", "heads", "head_dim")}
    else:
        a = {"wq": ("embed", "heads", "head_dim")}
    a.update({"wkv_a": ("embed", "lora"), "kv_norm": ("lora",),
              "wk_b": ("lora", "heads", "head_dim"), "wv_b": ("lora", "heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed")})
    return a


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    m = cfg.mla
    if m.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
        cq = apply_norm({"scale": p["q_norm"]}, cq)
        q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
            kv_cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos: Optional[int] = None):
    """MLA attention.  Without a cache (the train path) K and V are expanded
    from the latent and causal attention runs over [nope | rope] head dims
    through the flash kernels, the rotary keys broadcast over the heads, as
    JAX's no-cache branch.  With the latent cache ({"ckv": [B, T, kv_lora],
    "krope": [B, T, rope]}: one layer's bf16 slices), for the prefill and
    the decode step alike: x's latent and rotary keys are written into the
    cache at `cache_pos` IN PLACE, then attention runs ABSORBED in the
    latent space in fp32, as JAX's cache branch computes it.  The einsums
    read the first cache_pos + s rows; JAX reads all T, whose masked rows
    weigh exactly 0.  Returns (y, kv_cache)."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)

    ckv_full = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    # the norm reads the latent columns in place, rows at the projection's pitch
    ckv = apply_norm({"scale": p["kv_norm"]}, ckv_full[..., :m.kv_lora_rank])
    k_rope = apply_rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]

    if kv_cache is None:
        h = cfg.n_heads
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_rope.shape[:2], h,
                                                                 m.qk_rope_dim)], dim=-1)
        out = constrain_heads(_flash(constrain_heads(q_cat), constrain_heads(k_cat),
                                     constrain_heads(v), scale))
        y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
        return y, None

    s = x.shape[1]
    kv_len = cache_pos + s
    cc, cr = kv_cache["ckv"], kv_cache["krope"]
    cc[:, cache_pos:kv_len] = ckv.to(cc.dtype)
    cr[:, cache_pos:kv_len] = k_rope.to(cr.dtype)
    ccf, crf = cc[:, :kv_len].float(), cr[:, :kv_len].float()
    # absorption: q' = W_uk^T q_nope lives in the latent space
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(), p["wk_b"].float())
    scores = (torch.einsum("bshr,btr->bhst", q_lat, ccf)
              + torch.einsum("bshk,btk->bhst", q_rope.float(), crf)) * scale
    t_idx = torch.arange(kv_len, device=x.device)
    q_idx = cache_pos + torch.arange(s, device=x.device)
    w = torch.softmax(scores.masked_fill(t_idx[None, :] > q_idx[:, None], -1e30), dim=-1)
    lat = torch.einsum("bhst,btr->bshr", w, ccf)
    out = torch.einsum("bshr,rhk->bshk", lat, p["wv_b"].float())
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, kv_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                   device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"ckv": _zeros((n_layers, batch, max_len, m.kv_lora_rank), device),
            "krope": _zeros((n_layers, batch, max_len, m.qk_rope_dim), device)}


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


def mlp_axes(cfg: ModelConfig) -> Axes:
    if cfg.act == "gelu":
        return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # the [B,S,ff] intermediates stay token-sharded ("bsf"): where x's
    # sequence is split, each rank runs the whole FFN on its tokens; else
    # (decode) the ff dim stays split over "model" (`_product`)
    if "wi" in p:
        h = F.gelu(constrain(_product("bsd,df->bsf", x, p["wi"]), "bsf").float(),
                   approximate="tanh")
        return _product("bsf,fd->bsd", h.to(x.dtype), p["wo"])
    g = F.silu(constrain(_product("bsd,df->bsf", x, p["wi_gate"]), "bsf").float())
    u = constrain(_product("bsd,df->bsf", x, p["wi_up"]), "bsf").float()
    return _product("bsf,fd->bsd", (g * u).to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based top-k)
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    mo = cfg.moe
    d, e = cfg.d_model, mo.n_experts
    ff = mo.d_expert_ff or cfg.d_ff
    p = {"router": _dense_init(gen, (d, e), d, device, dtype=torch.float32),
         "wi_gate": _dense_init(gen, (e, d, ff), d, device),
         "wi_up": _dense_init(gen, (e, d, ff), d, device),
         "wo": _dense_init(gen, (e, ff, d), ff, device)}
    if mo.router == "sigmoid":
        p["router_bias"] = _zeros((e,), device, torch.float32)
    if mo.n_shared:
        p["shared"] = init_mlp(cfg, gen, device, d_ff=ff * mo.n_shared)
    return p


def moe_axes(cfg: ModelConfig) -> Axes:
    a: Axes = {"router": ("embed", "experts_nosplit"),
               "wi_gate": ("experts", "embed", "mlp"), "wi_up": ("experts", "embed", "mlp"),
               "wo": ("experts", "mlp", "embed")}
    if cfg.moe.router == "sigmoid":
        a["router_bias"] = ("experts_nosplit",)
    if cfg.moe.n_shared:
        a["shared"] = mlp_axes(cfg)
    return a


def moe_route(p: Params, xt: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt [t, d] -> (scores [t, e] fp32, top_idx [t, k] int64, top_w [t, k]
    fp32): the router of `apply_moe`.  The sigmoid router (deepseek-v3)
    selects by score + `router_bias` and weighs by the renormalised scores;
    both scale the weights by `router_scale`."""
    mo = cfg.moe
    logits = xt.float() @ p["router"]
    if mo.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel_scores = scores + p["router_bias"]     # bias for load balance only
    else:
        scores = torch.softmax(logits, dim=-1)
        sel_scores = scores
    # jax.lax.top_k's order: largest first, the lower index first among equal
    # scores; a stable descending sort promises it, torch.topk does not
    top_idx = torch.sort(sel_scores, dim=-1, descending=True, stable=True).indices
    top_idx = top_idx[:, :mo.top_k]
    top_w = torch.gather(scores, 1, top_idx)
    if mo.router == "sigmoid":
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
    return scores, top_idx, top_w * mo.router_scale


def moe_slots(top_idx: torch.Tensor, n_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """top_idx [t, k] -> (counts [e] int64, keep [t, k] bool, pos [t, k]
    int64): each route's position in its expert's buffer, by a stable sort
    of the flat expert ids (token-major, then j), as JAX numbers them.  A
    route past `capacity` is dropped (keep False) and its pos clipped to
    capacity - 1.  No step reads a count back to the host."""
    flat_e = top_idx.reshape(-1)
    n = flat_e.numel()
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    order = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, dtype=order.dtype, device=order.device))
    pos_flat = ranks - (torch.cumsum(counts, 0) - counts)[flat_e]
    keep = (pos_flat < capacity).reshape(top_idx.shape)
    return counts, keep, pos_flat.clamp(0, capacity - 1).reshape(top_idx.shape)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE, as JAX's `apply_moe`.  Returns (y, aux).

    Every expert runs on its [capacity, d] buffer (batched products), so a
    decode step computes all experts.  The buffer is built by one gather:
    each kept route owns a distinct (expert, slot), which holds its token's
    row; a slot no route keeps holds zeros.  That is the buffer of JAX's k
    scatter-adds, where a dropped route adds a zero row at slot capacity - 1.
    The combine sums the k weighted rows in fp32 in j order."""
    mo = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, mo.n_experts, mo.top_k
    xt = x.reshape(t, d)
    scores, top_idx, top_w = moe_route(p, xt, cfg)
    capacity = int(max(1, math.ceil(t * k / e * mo.capacity_factor)))
    counts, keep, pos = moe_slots(top_idx, e, capacity)
    # load-balancing aux loss (switch-style)
    aux = (counts.float() / t * scores.mean(0)).sum() * e / k

    # dispatch: the token of every (expert, slot), t (a zero row) where none;
    # dropped routes write to one spare slot past the end, which is discarded
    slot = top_idx * capacity + pos                                # [t, k]
    tok = torch.arange(t, device=x.device)[:, None].expand(t, k)
    src = torch.full((e * capacity + 1,), t, dtype=torch.long, device=x.device)
    src.scatter_(0, torch.where(keep, slot, e * capacity).reshape(-1), tok.reshape(-1))
    buf = torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]].view(e, capacity, d)

    # expert FFNs: [e, c, d] x [e, d, f]; silu in fp32, product kept bf16
    g = F.silu(torch.bmm(buf, p["wi_gate"]).float()).to(xt.dtype)
    u = torch.bmm(buf, p["wi_up"])
    eo = torch.bmm(g * u, p["wo"])

    # combine: the k rows of each token, weighted, summed in fp32 in j order
    w = (top_w * keep).float()
    rows = eo.reshape(e * capacity, d)[slot].float() * w[..., None]     # [t, k, d]
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    if mo.n_shared:
        y = y + apply_mlp(p["shared"], xt[None], cfg)[0].float()
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# embeddings / output head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p = {"tok": _dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                                device)
    return p


def embed_axes(cfg: ModelConfig) -> Axes:
    a = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["head"] = ("embed", "vocab")
    return a


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        return _embed_sharded(p["tok"], tokens)
    return F.embedding(tokens, p["tok"])


def _embed_sharded(table: DTensor, tokens: DTensor) -> DTensor:
    """The lookup of each rank's tokens in the whole table (gathered; a
    lookup in a vocab-sharded table, DTensor's masked partial, fails beside
    batch-sharded tokens): the rows take the tokens' placements, and the
    local table gradient is a partial sum on the mesh dims that split the
    tokens."""
    mesh = tokens.device_mesh
    pl = list(tokens.placements)
    rep_ = [Replicate()] * mesh.ndim
    fn = local_map(F.embedding, out_placements=pl, in_placements=(pl, rep_),
                   in_grad_placements=(pl, [Partial() if isinstance(q, Shard) else q
                                            for q in pl]), device_mesh=mesh)
    return fn(tokens, table.redistribute(mesh, rep_))


def head_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output head's product in the params' dtype: what the fused
    cross-entropy reads (JAX casts it to fp32 first, which changes no value)."""
    if cfg.tie_embeddings:
        return _product("bsd,vd->bsv", h, p["tok"])
    return _product("bsd,dv->bsv", h, p["head"])


def lm_logits(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return head_logits(p, h, cfg).float()

"""Sharding policy of the port: logical parameter/cache axes -> mesh axes.

The port's copy of `repro/runtime/sharding.py`: one table drives FSDP x TP
x EP for every architecture.

  logical axis          mesh axis       role
  -----------------     -----------     ------------------------------
  vocab, heads, mlp,    "model"         tensor / expert parallelism
  kv_heads, experts
  embed                 "data"          FSDP (ZeRO-3 weight sharding;
                                        gathered on use by DTensor)
  lora, head_dim, ...   (replicated)    small dims

A dim is only sharded when divisible by the axis size (e.g. kv_heads=8 on a
16-way model axis stays replicated — Megatron-style KV duplication for GQA).
Batch shards over ("pod","data"); for long-context single-sequence shapes the
SEQUENCE dim shards over "data" instead (sequence parallelism).

The functions that compute specs are pure: they take a mesh shape, a
mapping of axis name to size (`mesh_shape(device_mesh)` builds it from a
`DeviceMesh`), so they run with no process group.  A spec is a tuple with
one entry a tensor dim, equal entry for entry to `tuple(PartitionSpec)` of
the JAX version: an entry is None, an axis name, or a tuple of two or more
axis names (a one-name tuple reads as the name, an empty one as None); a
param's spec has its trailing Nones trimmed, as `spec_for` trims JAX's.
`placements` turns a spec into DTensor placements on a `DeviceMesh`, and
`distribute_tree` and `distribute_params` place a tree.  `product_plan`
places the two operands of each of the model's products for it.

The port keeps one param dict a layer (`params["blocks"][i]`), where JAX
stacks the blocks into `[L, ...]` leaves: JAX's spec of a stacked leaf is
`(None, *spec)` of the port's, trimmed.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..configs.base import InputShape, ModelConfig

PyTree = Any
Spec = Tuple[Any, ...]
MeshShape = Mapping[str, int]

LOGICAL_TO_MESH: Dict[Optional[str], Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "embed": "data",          # FSDP
    "lora": None,
    "head_dim": None,
    "experts_nosplit": None,
    "heads_nosplit": None,
    None: None,
}


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True                  # shard "embed" over data
    fsdp_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)

    def mesh_axes_for(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        tgt = LOGICAL_TO_MESH.get(logical)
        if tgt == "data":
            return self.fsdp_axes if self.fsdp else None
        if tgt == "model":
            return self.model_axes
        return None


def mesh_shape(device_mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` with named dims (read without
    touching its rank tensor, so it works under a fake tensor mode)."""
    return {name: device_mesh.size(i) for i, name in enumerate(device_mesh.mesh_dim_names)}


def _entry(e):
    """One spec entry as JAX's PartitionSpec normalises it."""
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _spec(*parts) -> Spec:
    return tuple(_entry(p) for p in parts)


def _axis_size(mesh: MeshShape, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh[a]
    return n


def spec_for(axes_entry: Tuple, shape: Tuple[int, ...], mesh: MeshShape,
             policy: ShardingPolicy) -> Spec:
    """The spec of one param given its logical axes and shape.  Dims that
    do not divide evenly stay replicated."""
    parts = []
    used = set()
    for dim, logical in enumerate(axes_entry):
        target = policy.mesh_axes_for(logical)
        if target is None or any(t in used for t in target):
            parts.append(None)
            continue
        if shape[dim] % _axis_size(mesh, target) != 0:
            parts.append(None)
            continue
        parts.append(target)
        used.update(target)
    while parts and parts[-1] is None:
        parts.pop()
    return _spec(*parts)


def map_specs(params: PyTree, axes: PyTree, fn) -> PyTree:
    """fn(leaf, its axes tuple or None) over the leaves of `params`, looking
    the axes up by the same keys (a leaf the axes tree lacks gets None)."""
    if isinstance(params, dict):
        return {k: map_specs(v, axes.get(k) if isinstance(axes, dict) else None, fn)
                for k, v in params.items()}
    if isinstance(params, list):
        ok = isinstance(axes, list)
        return [map_specs(v, axes[i] if ok and i < len(axes) else None, fn)
                for i, v in enumerate(params)]
    return fn(params, axes if isinstance(axes, tuple) else None)


def param_specs(params: PyTree, axes_tree: PyTree, mesh: MeshShape,
                policy: ShardingPolicy) -> PyTree:
    """The spec tree matching `params` (the port's layout, one dict a
    layer; leaves need only a `.shape`).  A leaf of higher rank than its
    axes has its leading extra dims replicated, as JAX treats a stacked
    layer dim; a leaf with no axes entry is replicated."""
    def one(leaf, ax):
        if ax is None:
            return ()
        shape = tuple(leaf.shape)
        return spec_for((None,) * (len(shape) - len(ax)) + tuple(ax), shape, mesh, policy)
    return map_specs(params, axes_tree, one)


# ---------------------------------------------------------------------------
# batch / activation / cache specs
# ---------------------------------------------------------------------------

def batch_axes(mesh: MeshShape) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh)


def batch_spec(mesh: MeshShape, global_batch: int, seq_len: int) -> Spec:
    """Shard batch over (pod, data); if the batch is too small (long-context
    decode), fall back to sequence sharding over the same axes (SP)."""
    ba = batch_axes(mesh)
    n = _axis_size(mesh, ba)
    if global_batch % n == 0:
        return _spec(ba, None)
    if seq_len % n == 0:
        return _spec(None, ba)
    return ()


def activation_specs_for(mesh: MeshShape, shape: InputShape,
                         cfg: Optional[ModelConfig] = None
                         ) -> Dict[str, Optional[Spec]]:
    """Named activation specs for the cell (see `repro_torch.context`):
    'bsd' residual stream; 'heads'/'kv' attention-interior layouts (heads
    over the model axis, FULL sequence) — the Megatron seq<->head
    transition, set only when both the query and the kv heads divide the
    model axis; 'bsf' the FFN intermediates (train and prefill only); 'ecd'
    the MoE dispatch, left unconstrained as JAX leaves it."""
    bsd = activation_spec_for(mesh, shape)
    m = mesh.get("model", 1)
    bsp = batch_spec(mesh, shape.global_batch, shape.seq_len)
    bdim = bsp[0] if bsp else None
    heads = kv = ecd = None
    if cfg is not None and m > 1 and shape.kind in ("train", "prefill"):
        if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
            heads = _spec(bdim, None, "model", None)
            kv = _spec(bdim, None, "model", None)
    bsf = bsd if shape.kind in ("train", "prefill") else None
    return {"bsd": bsd, "bsf": bsf, "heads": heads, "kv": kv, "ecd": ecd}


def activation_spec_for(mesh: MeshShape, shape: InputShape) -> Spec:
    """[B,S,D] residual-stream spec.  Train/prefill additionally shard the
    SEQUENCE dim over "model" (Megatron-style sequence parallelism); decode
    steps (S=1) keep the batch-only layout."""
    bsp = batch_spec(mesh, shape.global_batch, shape.seq_len)
    m = mesh.get("model", 1)
    if shape.kind in ("train", "prefill") and m > 1 and shape.seq_len % m == 0:
        parts = list(bsp) + [None] * (2 - len(bsp))
        if parts[1] is None:       # seq dim free -> give it the model axis
            parts[1] = "model"
        return _spec(*parts, None)
    return _spec(*bsp, None)


def batch_shardings(mesh: MeshShape, shape: InputShape, *, for_decode: bool = False
                    ) -> Dict[str, Spec]:
    """The spec of each batch entry (JAX's `batch_shardings` gives them as
    NamedShardings)."""
    if for_decode:
        # decode feeds [B, 1] token arrays: batch over data axes when
        # divisible, else replicated (long-context B=1: the CACHE is what
        # gets sequence-sharded, not the one-token input)
        ba = batch_axes(mesh)
        n = _axis_size(mesh, ba)
        sp = _spec(ba, None) if shape.global_batch % n == 0 else ()
    else:
        sp = batch_spec(mesh, shape.global_batch, shape.seq_len)
    return {"tokens": sp, "labels": sp, "loss_mask": sp, "embeds": _spec(*sp, None)}


def cache_specs(cfg: ModelConfig, mesh: MeshShape, batch: int, seq_len: int
                ) -> Dict[str, Any]:
    """Specs of the serve cache (structure mirrors `models.init_cache`)."""
    ba = batch_axes(mesh)
    n = _axis_size(mesh, ba)
    bdim = ba if batch % n == 0 else None
    # sequence dim of the KV cache: shard over data axes when batch can't be
    sdim = None if bdim is not None else ba
    m = mesh.get("model", 1)

    def kv():
        # [L, B, S, Hkv, dh]: kv heads over model when divisible, else the
        # sequence dim takes the model axis (paged-style cache sharding)
        hd = "model" if (cfg.n_kv_heads % m == 0 and m > 1) else None
        sd = tuple(sdim) if sdim else ()
        if hd is None and m > 1 and seq_len % m == 0:
            sd = sd + ("model",)
        sd = sd or None
        return {"k": _spec(None, bdim, sd, hd, None),
                "v": _spec(None, bdim, sd, hd, None)}

    if cfg.family in ("ssm", "hybrid"):
        dm_heads = (cfg.ssm.expand * cfg.d_model) // cfg.ssm.head_dim
        hspec = "model" if dm_heads % m == 0 else None
        conv_dim = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        cspec = "model" if conv_dim % m == 0 else None
        if cfg.family == "ssm":
            return {"ssm_state": {
                "conv": _spec(None, bdim, None, cspec),       # [L,B,W-1,C]
                "ssm": _spec(None, bdim, hspec, None, None),   # [L,B,H,P,N]
            }}
        return {"kv": kv(),
                "conv": _spec(None, None, bdim, None, cspec),  # [NB,7,B,W-1,C]
                "ssm": _spec(None, None, bdim, hspec, None, None)}
    if cfg.mla is not None:
        lspec = "model" if cfg.mla.kv_lora_rank % m == 0 else None
        rspec = "model" if cfg.mla.qk_rope_dim % m == 0 else None
        return {"mla": {
            "ckv": _spec(None, bdim, sdim if lspec is None else None, lspec),
            "krope": _spec(None, bdim, sdim if rspec is None else None, rspec),
        }}
    return {"kv": kv()}


# ---------------------------------------------------------------------------
# placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: Spec, device_mesh) -> list:
    """One placement a mesh dim: `Shard(d)` where entry d of `spec` names
    the dim's axis (a tensor dim over several axes is split in mesh-dim
    order, as JAX splits it in the entry's order when that is the mesh's),
    else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def distribute(t: torch.Tensor, device_mesh, pl: Sequence) -> Any:
    """`t`, the same full tensor on every rank, as a DTensor of placements
    `pl`, with no collective: each rank keeps its own shard (a copy, where a
    mesh dim of size > 1 splits it, so the full tensor can be freed; `t`
    itself otherwise).  requires_grad is kept."""
    from torch.distributed.tensor import DTensor, Shard
    local = t.detach()
    coord = device_mesh.get_coordinate()
    split = False
    for i, p in enumerate(pl):
        n = device_mesh.size(i)
        if isinstance(p, Shard) and n > 1:
            local = local.chunk(n, dim=p.dim)[coord[i]]
            split = True
    if split:
        local = local.clone()
    return DTensor.from_local(local, device_mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride()).requires_grad_(t.requires_grad)


def misplaced(tree: PyTree, specs: PyTree, device_mesh, prefix: str = "") -> list:
    """Dotted names of the leaves of `tree` that are not DTensors at the
    placements (and local shape) their spec in `specs` gives on
    `device_mesh`; a leaf whose spec is None is not looked at."""
    from torch.distributed.tensor import DTensor, Shard
    out = []

    def check(t, s, name):
        if s is None:
            return
        pl = placements(s, device_mesh)
        local = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= device_mesh.size(i)
        if not isinstance(t, DTensor) or list(t.placements) != pl or list(
                t.to_local().shape) != local:
            out.append(name)

    def walk(t, s, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s.get(k) if isinstance(s, dict) else None, f"{name}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, s[i] if isinstance(s, list) else None, f"{name}{i}.")
        else:
            check(t, s if isinstance(s, tuple) else None, name[:-1])
    walk(tree, specs, prefix)
    return out


def distribute_tree(tree: PyTree, specs: PyTree, device_mesh) -> PyTree:
    """Each leaf of `tree` (the same on every rank) as a DTensor placed by
    its spec in `specs`, a tree of the same structure; a leaf whose spec is
    None stays as it is."""
    return map_specs(tree, specs, lambda t, s: t if s is None else distribute(
        t, device_mesh, placements(s, device_mesh)))


def distribute_params(params: PyTree, axes_tree: PyTree, device_mesh,
                      policy: ShardingPolicy = ShardingPolicy()) -> PyTree:
    """`params` (the same on every rank) as DTensors placed by the table."""
    return distribute_tree(params, param_specs(params, axes_tree, mesh_shape(device_mesh),
                                               policy), device_mesh)


# ---------------------------------------------------------------------------
# the placement of a product's operands
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProductPlan:
    """How einsum(eq, x, w) of an activation x and a weight w runs on a
    mesh: x and w redistributed to `x` and `w`.  With `row` set, a mesh dim
    splits a contracted dim of both, and each rank's product is a partial
    sum of placements `out` (`Partial` on those dims), computed as an fp32
    result of the operands as they are and summed in fp32; `x_grad` and
    `w_grad` are the placements of the local gradients.  Without it the
    product is DTensor's own einsum of the two."""
    x: Tuple[Any, ...]
    w: Tuple[Any, ...]
    row: bool = False
    out: Tuple[Any, ...] = ()
    x_grad: Tuple[Any, ...] = ()
    w_grad: Tuple[Any, ...] = ()


@functools.lru_cache(maxsize=None)
def product_plan(eq: str, x_pl: Tuple[Any, ...], w_pl: Tuple[Any, ...], sizes: Tuple[int, ...],
                 x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                 w_itemsize: int) -> ProductPlan:
    """The operands' placements for einsum(eq, x, w), per mesh dim of size
    `sizes[i]` (a dim of size 1 keeps both as they are, but for a split of
    a weight dim of size 1, made whole: one kv head on a 1 x 1 mesh, which
    DTensor's einsum views away and its sharding propagation refuses),
    worked out once a layout.  Where x splits a dim the product contracts
    (heads, ff: the row-parallel half of tensor parallelism), w keeps its
    own split there and the product is a partial sum (`row`); where x
    splits another dim (its batch), w is whole on it (the FSDP split of
    d_model is gathered at use); where x is whole, w keeps a split of an
    output dim (heads, ff, vocab: column parallel), and a split of a
    contracted dim is either gathered or, where the fp32 sum of the output
    moves fewer bytes than the gather (a decode step's few tokens), taken
    as a row split by splitting x there, a local slice."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    (xs, ws), out = eq.split("->")[0].split(","), eq.split("->")[1]
    split = math.prod(n for n, p in zip(sizes, x_pl) if p.is_shard())
    tokens = math.prod(x_shape) // split // math.prod(
        x_shape[i] for i, c in enumerate(xs) if c in ws)
    small_out = 8 * tokens * math.prod(
        w_shape[i] for i, c in enumerate(ws) if c in out) < math.prod(w_shape) * w_itemsize
    xpl = list(x_pl)
    for i, (p, q) in enumerate(zip(x_pl, w_pl)):
        if (sizes[i] > 1 and not p.is_shard() and q.is_shard() and ws[q.dim] not in out
                and small_out):
            xpl[i] = Shard(xs.index(ws[q.dim]))
    rows = [sizes[i] > 1 and p.is_shard() and xs[p.dim] in ws and xs[p.dim] not in out
            for i, p in enumerate(xpl)]
    wpl = [(Replicate() if q.is_shard() and w_shape[q.dim] == 1 else q) if sizes[i] == 1 else
           q if rows[i] else
           Replicate() if p.is_shard() or (q.is_shard() and ws[q.dim] not in out) else q
           for i, (p, q) in enumerate(zip(xpl, w_pl))]
    if not any(rows):
        return ProductPlan(tuple(xpl), tuple(wpl))
    outs, xg, wg = [], [], []
    for i, (p, q) in enumerate(zip(xpl, wpl)):
        x_tokens = p.is_shard() and xs[p.dim] not in ws       # x split on its batch or sequence
        w_out = q.is_shard() and ws[q.dim] in out              # w split on an output dim
        outs.append(Partial() if rows[i] else
                    Shard(out.index(xs[p.dim])) if x_tokens else
                    Shard(out.index(ws[q.dim])) if w_out else Replicate())
        xg.append(Partial() if sizes[i] > 1 and w_out else p)
        wg.append(Partial() if sizes[i] > 1 and x_tokens else q)
    return ProductPlan(tuple(xpl), tuple(wpl), True, tuple(outs), tuple(xg), tuple(wg))

"""Step functions of the port: the counterpart of `repro/runtime/steps.py`
(train, serve, and the abstract-state functions), the logical-axes tree
(`model_axes`) and the placement of a train state, params, a serve cache and
a batch on a `DeviceMesh` (`shard_train_state`, `shard_params`,
`shard_cache`, `shard_batch`).

A sharded step is the same `train_step`, `prefill_step` or `serve_step` on
DTensors, called inside `context.activation_specs(sharding.
activation_specs_for(mesh_shape(mesh), shape, cfg))`, as JAX's dry run jits
it under them: the state and the cache come out at the placements they went
in with (`launch/dryrun.py`'s cells).  Every family runs under a mesh.

The abstract-state functions (`abstract_params`, `abstract_opt_state`,
`abstract_state`, `abstract_cache`, `abstract_batch`) build the same trees
as `init_model`, `init_opt_state`, `init_cache` and the batches the entry
points feed, as fake tensors of a `FakeTensorMode` (the analogue of
`jax.eval_shape`): shapes, dtypes and a device, no memory.  Every draw of
`init_model` runs under the mode, so a full-size model allocates nothing.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..configs.base import InputShape, ModelConfig
from ..models import layers as L
from ..models.transformer import (_hybrid_block_axes, _layer_is_moe, _ssm_layer_axes,
                                  _tf_layer_axes, decode_step, init_cache, init_model,
                                  loss_fn, prefill)
from ..optim import AdamWConfig, adamw_update, init_opt_state
from ..tree import tree_leaves, tree_unflatten
from . import sharding as sh

# ---------------------------------------------------------------------------
# logical axes and placement
# ---------------------------------------------------------------------------


def model_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical-axes tree of `init_model(cfg, ...)`'s params, in the
    port's list layout (`blocks[i]`, `prefix[i]`, a hybrid block's
    `layers[j]`, `mtp`): every leaf's tuple is JAX's (whose stacked tree
    keeps one entry for all blocks)."""
    axes: Dict[str, Any] = {"embed": L.embed_axes(cfg), "final_norm": L.norm_axes(cfg)}
    if cfg.family == "ssm":
        axes["blocks"] = [_ssm_layer_axes(cfg) for _ in range(cfg.n_layers)]
        return axes
    if cfg.family == "hybrid":
        axes["blocks"] = [_hybrid_block_axes(cfg)
                          for _ in range(cfg.n_layers // cfg.hybrid.period)]
        return axes
    n_prefix = cfg.moe.n_dense_prefix if cfg.moe else 0
    if n_prefix:
        axes["prefix"] = [_tf_layer_axes(cfg) for _ in range(n_prefix)]
    axes["blocks"] = [_tf_layer_axes(cfg, moe=_layer_is_moe(cfg, i))
                      for i in range(n_prefix, cfg.n_layers)]
    if cfg.mtp:
        axes["mtp"] = {"layer": _tf_layer_axes(cfg), "norm": L.norm_axes(cfg)}
    return axes


def train_state_specs(params: Any, cfg: ModelConfig, mesh: sh.MeshShape,
                      policy: sh.ShardingPolicy = sh.ShardingPolicy()) -> Dict[str, Any]:
    """The spec tree of a train state with these params: both moments at
    their param's spec, the step counter None (a plain tensor, the same on
    every rank), as JAX's train cell places the state."""
    specs = sh.param_specs(params, model_axes(cfg), mesh, policy)
    return {"params": specs, "opt": {"m": specs, "v": specs, "step": None}}


def shard_train_state(state: Dict[str, Any], cfg: ModelConfig, mesh,
                      policy: sh.ShardingPolicy = sh.ShardingPolicy()) -> Dict[str, Any]:
    """`state` (the same on every rank) on the `DeviceMesh`: every param
    and both moments a DTensor at the placements the table gives the param
    (no collective: each rank keeps its shard)."""
    return sh.distribute_tree(
        state, train_state_specs(state["params"], cfg, sh.mesh_shape(mesh), policy), mesh)


def shard_params(params: Any, cfg: ModelConfig, mesh,
                 policy: sh.ShardingPolicy = sh.ShardingPolicy()) -> Any:
    """`params` (the same on every rank) as DTensors at `param_specs`, as
    JAX's serve cells place them."""
    return sh.distribute_params(params, model_axes(cfg), mesh, policy)


def shard_cache(cache: Any, cfg: ModelConfig, mesh, batch: int, max_len: int) -> Any:
    """`cache` (`init_cache(cfg, batch, max_len, ...)`, the same on every
    rank) as DTensors at `cache_specs`."""
    return sh.distribute_tree(cache, sh.cache_specs(cfg, sh.mesh_shape(mesh), batch, max_len),
                              mesh)


def shard_batch(batch: Dict[str, torch.Tensor], mesh, shape: InputShape, *,
                for_decode: bool = False) -> Dict[str, torch.Tensor]:
    """`batch` (the same on every rank) as DTensors placed by
    `batch_shardings` (a decode step's one-token batch with `for_decode`)."""
    specs = sh.batch_shardings(sh.mesh_shape(mesh), shape, for_decode=for_decode)
    return {k: sh.distribute(v, mesh, sh.placements(specs.get(k, ()), mesh))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     gen: Optional[torch.Generator] = None, device="cpu", *,
                     params: Any = None) -> Dict[str, Any]:
    """Params (random from `gen`, or the given ones) that require grad, and
    a fresh optimizer state."""
    if params is None:
        with torch.no_grad():
            params = init_model(cfg, gen, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def param_grads(loss: torch.Tensor, leaves) -> Tuple[torch.Tensor, ...]:
    """The gradient of `loss` in every leaf, as `jax.grad` gives it: a leaf
    the loss does not reach (the sigmoid router's `router_bias`, which only
    shifts the selection) gets zeros of its shape and dtype (and of its
    placements, for a DTensor leaf).  A DTensor leaf's gradient comes at
    the leaf's placements."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return tuple(g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) and g.placements != p.placements else g
                 for g, p in zip(grads, leaves))


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, opt_cfg: AdamWConfig
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Gradients of `loss_fn` over every param leaf, then one AdamW update
    (in place, see `adamw_update`).  Metrics are detached plain device
    tensors (a sharded step's are gathered)."""
    params = state["params"]
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, cfg)
        grads = param_grads(loss, leaves)
    new_params, new_opt, opt_metrics = adamw_update(
        tree_unflatten(params, list(grads)), state["opt"], params, opt_cfg)
    metrics = {k: _plain(v.detach()) for k, v in {**metrics, **opt_metrics}.items()}
    return {"params": new_params, "opt": new_opt}, metrics


def make_train_step_fn(cfg: ModelConfig, opt_cfg: AdamWConfig):
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def prefill_step(params: Any, cache: Any, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    return prefill(params, batch, cfg, cache)


def serve_step(params: Any, cache: Any, batch: Dict[str, torch.Tensor],
               pos: int, cfg: ModelConfig):
    """One-token decode against a cache filled to `pos`."""
    return decode_step(params, batch, cfg, cache, pos)


# ---------------------------------------------------------------------------
# abstract (fake tensor) state: no allocation
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, device="cuda", mode: Optional[FakeTensorMode] = None):
    """`init_model(cfg, ...)`'s tree as fake tensors of `mode` (a new one by
    default)."""
    with mode or FakeTensorMode(), torch.no_grad():
        return init_model(cfg, torch.Generator(device=device).manual_seed(0), device)


def abstract_opt_state(params: Any, opt_cfg: AdamWConfig,
                       mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """`init_opt_state(params, opt_cfg)` for fake `params`."""
    with mode or FakeTensorMode():
        return init_opt_state(params, opt_cfg)


def abstract_state(cfg: ModelConfig, opt_cfg: AdamWConfig, device="cuda",
                   mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """`make_train_state`'s state (params that require grad, the optimizer
    state) as fake tensors."""
    mode = mode or FakeTensorMode()
    params = abstract_params(cfg, device, mode)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": abstract_opt_state(params, opt_cfg, mode)}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
                   mode: Optional[FakeTensorMode] = None) -> Any:
    """`init_cache(cfg, batch, max_len, ...)` as fake tensors."""
    with mode or FakeTensorMode():
        return init_cache(cfg, batch, max_len, device)


def abstract_batch(cfg: ModelConfig, shape: InputShape, *, for_decode: bool = False,
                   device="cuda", mode: Optional[FakeTensorMode] = None
                   ) -> Dict[str, torch.Tensor]:
    """The batch the entry points feed a step of `shape`, as fake tensors:
    tokens [B, S] (S 1 `for_decode`) int64, as `Server` and the Trainer
    make them (JAX's are int32); a train shape's labels int64 and loss_mask
    fp32; a stub frontend's embeds [B, S, D] bf16."""
    b, s = shape.global_batch, 1 if for_decode else shape.seq_len
    with mode or FakeTensorMode():
        batch = {"tokens": torch.zeros((b, s), dtype=torch.long, device=device)}
        if shape.kind == "train":
            batch["labels"] = torch.zeros((b, s), dtype=torch.long, device=device)
            batch["loss_mask"] = torch.zeros((b, s), dtype=torch.float32, device=device)
        if cfg.frontend is not None:
            batch["embeds"] = torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16,
                                          device=device)
    return batch

"""Step functions of the port: the counterpart of `repro/runtime/steps.py`
(train and serve; the abstract-state builders have no counterpart yet)."""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.transformer import decode_step, init_model, loss_fn, prefill
from ..optim import AdamWConfig, adamw_update, init_opt_state
from ..tree import tree_leaves, tree_unflatten

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
    shifts the selection) gets zeros of its shape and dtype."""
    return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, opt_cfg: AdamWConfig
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Gradients of `loss_fn` over every param leaf, then one AdamW update
    (in place, see `adamw_update`).  Metrics are detached device tensors."""
    params = state["params"]
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, cfg)
        grads = param_grads(loss, leaves)
    new_params, new_opt, opt_metrics = adamw_update(
        tree_unflatten(params, list(grads)), state["opt"], params, opt_cfg)
    metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
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

"""Carry params between the JAX package's layout and the port's.

`from_jax_params` takes the JAX params as nested dicts of numpy arrays (for
example `jax.tree_util.tree_map(np.asarray, params)`), so this module itself
imports no JAX; `to_jax_params` gives the port's params (or grads) back as
such numpy dicts.  Leaf names and einsum layouts are kept (`wq` [d,H,dh],
`wo` [H,dh,d], the Mamba2 `in_proj` [d,in], `conv_w` [W,C], the MoE
experts' `wi_gate` [E,d,ff], ...); the stacked `[L, ...]` leaves of
`params["blocks"]` become one param dict per layer and back, for the dense,
moe and ssm families; a hybrid model's stacked `[NB, ...]` period blocks
become one dict a block, `{"layers": [period layer dicts]}`, and back.  The
MoE family's dense `prefix` layers and deepseek-v3's `mtp` head are
unstacked in JAX too, and cross as they are.
fp32 leaves (the SSM's `A_log`, `D`, `dt_bias`, the MoE `router` and
`router_bias`) stay fp32, and a tied embedding is the one `tok` leaf.  bf16
crosses as its bits, through an `int16` view.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .tree import tree_map


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (bf16 arrive as `ml_dtypes.bfloat16`) as a tensor of
    the same dtype and values."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":   # torch.from_numpy refuses ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


_UNSTACKED = ("embed", "final_norm", "prefix", "mtp")


def n_blocks(cfg: ModelConfig, n_prefix: int = 0) -> int:
    """Entries of `params["blocks"]`: the period blocks of a hybrid model,
    else the layers after the dense prefix."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    return cfg.n_layers - n_prefix


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, device="cpu"
                    ) -> Dict[str, Any]:
    """JAX dense-decoder, MoE, Mamba2 or hybrid params (numpy leaves) -> the
    port's params."""
    extra = set(tree) - {"blocks", *_UNSTACKED}
    if extra:
        raise NotImplementedError(f"{cfg.name}: params {sorted(extra)} belong to "
                                  "features the port does not serve yet")
    out = {k: tree_map(lambda a: to_tensor(a, device), tree[k])
           for k in _UNSTACKED if k in tree}
    stacked = tree_map(lambda a: to_tensor(a, device), tree.get("blocks", {}))
    out["blocks"] = [tree_map(lambda t, i=i: t[i].clone(), stacked)
                     for i in range(n_blocks(cfg, len(tree.get("prefix", []))))]
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same values; bf16 comes out, bit for
    bit, as `np.dtype("bfloat16")`, which exists once `ml_dtypes` is
    imported (as JAX does)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_jax_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's dense-decoder, MoE, Mamba2 or hybrid params (or grads) ->
    the JAX layout, as numpy: the per-layer (per-block) dicts of `blocks`
    restacked to `[L, ...]` (`[NB, ...]`) leaves, `prefix` and `mtp` as they
    are; no `blocks` key where the params have none (a depth cut to the
    dense prefix)."""
    blocks = params["blocks"]
    n = n_blocks(cfg, len(params.get("prefix", [])))
    if len(blocks) != n:
        raise ValueError(f"{cfg.name}: {len(blocks)} blocks, config has {n}")
    out = {k: tree_map(to_numpy, params[k]) for k in _UNSTACKED if k in params}
    if blocks:       # a cut to the dense prefix has none (JAX always stacks some)
        out["blocks"] = tree_map(lambda *ts: np.stack([to_numpy(t) for t in ts]), *blocks)
    return out

"""Carry JAX `init_model` params across to the port.

`from_jax_params` takes the JAX params as nested dicts of numpy arrays (for
example `jax.tree_util.tree_map(np.asarray, params)`), so this module itself
imports no JAX.  Leaf names and einsum layouts are kept (`wq` [d,H,dh],
`wo` [H,dh,d], ...); the stacked `[L, ...]` leaves of `params["blocks"]`
become one param dict per layer.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A numpy array (bf16 arrive as `ml_dtypes.bfloat16`) as a tensor of
    the same dtype and values."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":   # torch.from_numpy refuses ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig, device="cpu"
                    ) -> Dict[str, Any]:
    """JAX dense-decoder params (numpy leaves) -> the port's params."""
    extra = set(tree) - {"embed", "final_norm", "blocks"}
    if extra:
        raise NotImplementedError(f"{cfg.name}: params {sorted(extra)} belong to "
                                  "families the port does not serve yet")
    stacked = _tree(tree["blocks"], lambda a: to_tensor(a, device))
    blocks = [_tree(stacked, lambda t, i=i: t[i].clone())
              for i in range(cfg.n_layers)]
    return {"embed": _tree(tree["embed"], lambda a: to_tensor(a, device)),
            "final_norm": _tree(tree["final_norm"], lambda a: to_tensor(a, device)),
            "blocks": blocks}

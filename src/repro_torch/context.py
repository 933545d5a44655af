"""Activation-sharding context of the port: the counterpart of `repro/context.py`.

DTensor propagates parameter placements op by op; the model anchors its
activation layouts at the points where JAX's does.  The caller installs a
dict of specs for the cell (`runtime.sharding.activation_specs_for`), and
the model applies them at layout-transition points:

  "bsd"   [B, S, D]      residual stream (batch x sequence-parallel)
  "bsf"   [B, S, ff]     FFN intermediates (token-sharded)
  "heads" [B, S, H, dh]  attention interior: heads sharded over "model",
                         sequence FULL — the Megatron seq<->head transition
  "kv"    [B, S, Hkv, dh] same for K/V (only when Hkv divides the model axis)

`constrain` returns its argument itself when no specs are installed, when
the kind's spec is None or when the tensor is a plain one (not a DTensor),
so the single-card serve and train paths issue no extra op.  `replicated`
lifts a tensor the model makes itself (rotary tables, positions, zeros) to
a replicated DTensor beside a DTensor activation, as DTensor refuses an op
that mixes the two.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .runtime.sharding import Spec, placements

_SPECS: contextvars.ContextVar[Optional[Dict[str, Optional[Spec]]]] = \
    contextvars.ContextVar("repro_torch_activation_specs", default=None)


@contextlib.contextmanager
def activation_specs(specs: Optional[Dict[str, Optional[Spec]]]) -> Iterator[None]:
    tok = _SPECS.set(specs)
    try:
        yield
    finally:
        _SPECS.reset(tok)


def recompute_kwargs() -> Dict[str, Any]:
    """Keyword arguments of `torch.utils.checkpoint` that install the
    current specs around the recompute too: the backward may run on
    autograd's own threads, which do not see this context.  Empty when no
    specs are installed."""
    specs = _SPECS.get()
    if specs is None:
        return {}
    return {"context_fn": lambda: (contextlib.nullcontext(), activation_specs(specs))}


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x redistributed to the placements of the installed `kind` spec."""
    specs = _SPECS.get()
    if specs is None or not isinstance(x, DTensor):
        return x
    spec = specs.get(kind)
    if spec is None or len(spec) > x.ndim:
        return x       # no spec, or a rank mismatch: leave unconstrained, as JAX
    mesh = x.device_mesh
    # a dim the mesh dim does not divide stays whole (as `spec_for` leaves a
    # param's): long_500k's one decode token against a sequence split
    pl = [Replicate() if isinstance(p, Shard) and x.shape[p.dim] % mesh.size(i) else p
          for i, p in enumerate(placements(spec, mesh))]
    return x if list(x.placements) == pl else x.redistribute(mesh, pl)


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "bsd")


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "heads")


def constrain_kv(x: torch.Tensor) -> torch.Tensor:
    return constrain(x, "kv")


def keep_shards(x: DTensor, dims) -> list:
    """x's placements with a shard kept only on a tensor dim in `dims`;
    every other mesh dim replicated."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` as a replicated DTensor on `like`'s mesh when `like` is a
    DTensor; `t` itself otherwise."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

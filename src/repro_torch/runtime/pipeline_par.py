"""GPipe-style pipeline parallelism over one mesh dim (default "pod"): the
port of `repro/runtime/pipeline_par.py`.

Stages = the ranks of the mesh dim, microbatches streamed through them
with point-to-point sends.  Each stage owns one slice of the layer stack;
activations hop stage -> stage once per microbatch — bubble fraction
(S-1)/(M+S-1) for S stages, M microbatches.

A self-contained reference implementation, exercised by the tests on a
host mesh (gloo); wiring it into the full train step is an opt-in.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import tree_map

PyTree = Any


def pipeline_forward(layer_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                     stage_params: PyTree, x: torch.Tensor, *, mesh,
                     axis: str = "pod", n_microbatches: int = 4) -> torch.Tensor:
    """Run x through the S pipeline stages of the `axis` dim of the
    `DeviceMesh`, JAX's tick schedule: n_microbatches + S - 1 ticks; at
    tick t stage 0 takes microbatch min(t, M - 1), every other stage what
    its predecessor sent at the tick before (zeros at first), each applies
    `layer_fn` with its own params, the last stage writes microbatch t - (S
    - 1) of the output once it exits, and every stage sends its result on.
    The last stage's output is then summed to every stage, so each rank
    returns the whole output.

    stage_params: a tree whose leaves have leading dim S — DTensors sharded
    over `axis` on dim 0 (each rank holds its stage's slice), or full
    tensors, of which each rank takes its own slice.  x: [B, ...], the same
    on every rank; each microbatch visits every stage.
    """
    names = mesh.mesh_dim_names
    s_stages = mesh.size(names.index(axis))
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} is not a multiple of n_microbatches {n_microbatches}")
    mb = b // n_microbatches
    params_mine = tree_map(lambda a: a.to_local()[0] if isinstance(a, DTensor) else a[stage],
                           stage_params)
    nxt = dist.get_global_rank(group, stage + 1) if stage < s_stages - 1 else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    inflight = torch.zeros((mb,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out = torch.zeros_like(x)
    for t in range(n_microbatches + s_stages - 1):
        mb_idx = min(t, n_microbatches - 1)
        stage_in = x[mb_idx * mb:(mb_idx + 1) * mb] if stage == 0 else inflight
        y = layer_fn(params_mine, stage_in)
        exit_idx = t - (s_stages - 1)
        if stage == s_stages - 1 and exit_idx >= 0:
            out[exit_idx * mb:(exit_idx + 1) * mb] = y
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            inflight = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, inflight, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)

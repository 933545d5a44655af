"""AdamW with global-norm clipping and schedule: the port of
`repro/optim/adamw.py`.

Moments can be kept in bf16 (`moment_dtype`) for states that would not fit
in fp32; the update math always runs in fp32.  JAX computes the update with
XLA ops outside any Pallas kernel, and so does this: plain torch ops, one
block of a leaf at a time (rows of its first dim, at most `BLOCK` elements),
so the fp32 temporaries stay a few hundred MB each whatever the leaf
(command-r-35b's tied table is 2.1 B elements: 8.4 GB a temporary if
updated whole).  The update is elementwise, so the blocks change no bit.
`step`, `lr`, the clip scale and the bias corrections stay fp32 tensors on
the params' device, so an update never waits for the host.

Unlike the JAX version, `adamw_update` writes the new params, moments and
step counter into the given tensors in place (a full-width train state has
no room for a second copy) and returns them: every leaf of the state that
comes out is the tensor that went in, which a CUDA graph of the train step
replays onto (`launch/train.py`).

A sharded state (DTensor params, their gradients at the params' placements)
takes the same update on each rank's local shards: the moments are made at
the params' placements, the global grad norm counts a leaf replicated over
a mesh dim once (each rank's local sums of squares are summed over the mesh
dims that split their leaves, one all-reduce a group of leaves split
alike), and the elementwise update runs on `to_local()` shards.  A plain
state takes exactly the path it always took.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..tree import tree_leaves, tree_map

PyTree = Any
BLOCK = 1 << 26             # elements of a leaf updated at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _decay_mask(params: PyTree) -> PyTree:
    """No weight decay on 1-D params, judged on the JAX layout: JAX stacks
    every block leaf to [L, ...] (`init_model`), so a block's norm scales and
    biases are 2-D there and decay; only leaves outside the blocks
    (`final_norm.scale`) can be 1-D.  The port keeps one dict per layer, so a
    leaf under `blocks` counts one dim more."""
    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked or k == "blocks") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        return tree.dim() + int(stacked) > 1
    return walk(params, False)


def init_opt_state(params: PyTree, cfg: AdamWConfig) -> Dict[str, Any]:
    device = tree_leaves(params)[0].device

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=cfg.moment_dtype, requires_grad=False)
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not any(isinstance(g, DTensor) for g in leaves):
        return torch.sqrt(sum(g.float().square().sum() for g in leaves))
    # DTensor leaves: the local sums of squares of the leaves split over the
    # same mesh dims (of size > 1), summed over those dims in one all-reduce;
    # the others' in leaf order, as a plain state's
    groups: Dict[Any, Any] = {}
    for g in leaves:
        split, local = (), g
        if isinstance(g, DTensor):
            split = tuple(not isinstance(p, Replicate) and g.device_mesh.size(i) > 1
                          for i, p in enumerate(g.placements))
            local = g.to_local()
        key = (g.device_mesh, split) if any(split) else None
        groups[key] = groups.get(key, 0) + local.float().square().sum()
    total = 0
    for key, sq in groups.items():
        if key is not None:
            mesh, split = key
            pl = [Partial() if s else Replicate() for s in split]
            sq = DTensor.from_local(sq, mesh, pl, run_check=False).full_tensor()
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: PyTree, opt: Dict[str, Any], params: PyTree,
                 cfg: AdamWConfig) -> Tuple[PyTree, Dict[str, Any], Dict[str, torch.Tensor]]:
    step = opt["step"].add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v, decay):
        if isinstance(p, DTensor):          # g, m and v at p's placements
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        if p.dim() == 0:
            p, g, m, v = (t.unsqueeze(0) for t in (p, g, m, v))
        rows = max(1, BLOCK // max(1, p[0].numel()))
        for r0 in range(0, p.shape[0], rows):
            sl = slice(r0, r0 + rows)
            upd_block(p[sl], g[sl], m[sl], v[sl], decay)

    def upd_block(p, g, m, v, decay):
        gf = g.float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        del gf
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if cfg.weight_decay and decay:
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)

    tree_map(upd, params, grads, opt["m"], opt["v"], _decay_mask(params))
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}

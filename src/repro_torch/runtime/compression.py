"""Gradient compression for cross-pod data parallelism: the port of
`repro/runtime/compression.py`.

The multi-pod mesh reduces gradients over the slow "pod" axis.  This module
reduces a gradient tree over one mesh dim with per-block int8 quantization
(a shared fp32 scale per block of `BLOCK` elements): each rank quantizes
its leaf, the int8 payload is summed in int32 across the dim (exact) and
the scales reduced by max, then the sum is dequantized with the max scale
and divided by the dim's size.  The quantization noise is bounded by the
block's scale.  The int32 sum moves 4 bytes an element (the int8 payload
widened, so that the sum is exact) and 4 bytes a block of scales, against
2 bytes an element for a bf16 all-reduce.

Used as an opt-in wrapper around the gradient tree BEFORE the optimizer
update.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_map

PyTree = Any

BLOCK = 256


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (q [n_blocks, BLOCK] int8, scale [n_blocks, 1] fp32), JAX's
    arithmetic: the flat fp32 leaf zero-padded to whole blocks, scale =
    max |block| / 127 + 1e-12, q = round-half-even(block / scale) clipped
    to +-127."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compressed_all_reduce(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of `g` over the `n` ranks of `group`, through the int8
    payload: an int32 SUM of the quantized blocks and a MAX of the scales,
    then dequantized and divided by n (in g's dtype, as JAX's)."""
    q, scale = _quantize(g)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return _dequantize(qsum, scale, g.shape, g.dtype) / n


def compressed_psum_tree(grads: PyTree, mesh, axis: str = "pod") -> PyTree:
    """All-reduce `grads` (plain tensors, the same shapes on every rank)
    over the `axis` dim of the `DeviceMesh` with int8 block quantization:
    the mean over the dim, each leaf by `compressed_all_reduce`.  The
    identity when the mesh has no such dim or it is of size 1."""
    names = mesh.mesh_dim_names or ()
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return grads
    group = mesh.get_group(axis)
    n = mesh.size(names.index(axis))
    return tree_map(lambda g: compressed_all_reduce(g, group, n), grads)

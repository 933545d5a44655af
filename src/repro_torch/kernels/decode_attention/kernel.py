"""Decode attention: the wrapper of the CUDA kernel in
`csrc/decode_attention.cu`.

Counterpart of `repro/kernels/decode_attention/kernel.py::decode_attention`.
One launch a call: a cluster of blocks per (sequence, kv head) splits the
sequence's live rows and combines its partials through distributed shared
memory in a fixed order, so the same inputs give the same bits.  T need not
be a multiple of any tile, rows at or past a sequence's length are never
read, and length 0 gives zeros.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `decode_attention.launches` counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .ref import decode_attention_ref

HEAD_DIMS = (32, 64, 80, 128)
CLUSTERS = (1, 2, 4, 8)
_SMS = 132                  # SMs of an H100 (and H200) SXM
_ARGTYPES = (_build.PTR,) * 5 + (_build.INT,) * 6 + (_build.FLOAT, _build.PTR, _build.PTR)


def cluster_size(items: int) -> int:
    """Blocks that split one sequence's rows, given `items` = B x Hkv x head
    chunks clusters: the largest of CLUSTERS whose grid stays within half the
    card's SMs, at least 1.  Measured at the serve lengths (PERF.md): 8 for
    chatglm3-6b's 8 kv groups (64 blocks; 4 is as fast, 16 and 2 slower),
    1 for stablelm-3b's 128 (sequence, head) pairs (2 and 4 slower): past
    that, a block's fixed costs (its first loads, two merges, the cluster
    barrier) outweigh its share of the rows."""
    c = CLUSTERS[0]
    for size in CLUSTERS:
        if size * items <= _SMS // 2:
            c = size
    return c


def head_chunks(rep: int) -> int:
    """Blocks a GQA group's `rep` query heads are cut into: the kernel takes
    16 heads a block up to rep 16, else 32."""
    return 1 if rep <= 16 else -(-rep // 32)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None,
                     cluster: Optional[int] = None) -> torch.Tensor:
    """q [B,H,D]; k,v [B,T,Hkv,D]; lengths [B] int32 -> out [B,H,D].
    `cluster` (one of CLUSTERS; default `cluster_size`) is the number of
    blocks that split each sequence's rows."""
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, lengths, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.require(x, name, torch.bfloat16, q.device)
    if (not lengths.is_cuda or lengths.device != q.device
            or lengths.dtype != torch.int32 or lengths.shape != (b,)
            or not lengths.is_contiguous()):
        raise ValueError("decode_attention: lengths must be a contiguous int32 "
                         f"[{b}] tensor on {q.device}")
    if (k.shape != (b, t, hkv, d) or v.shape != k.shape or h % hkv
            or d not in HEAD_DIMS or h // hkv > 32 * (128 // d)):
        raise ValueError(
            f"decode_attention: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)} (head dim one of "
            f"{HEAD_DIMS}, at most 32 * (128 // D) query heads per kv head)")
    if cluster is None:
        cluster = cluster_size(b * hkv * head_chunks(h // hkv))
    if cluster not in CLUSTERS:
        raise ValueError(f"decode_attention: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
    fn = _build.function("decode_attention_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, t, d, int(cluster), float(scale), strides,
            _build.stream(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

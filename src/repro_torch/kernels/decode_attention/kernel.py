"""Decode attention: the wrapper of the CUDA kernel in
`csrc/decode_attention.cu`.

Counterpart of `repro/kernels/decode_attention/kernel.py::decode_attention`.
The kernel splits the cache over T (flash-decoding) and combines the
partials in a second launch; both launches count as one call.  T need not be
a multiple of the kernel's chunk, and length 0 gives zeros.

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

HEAD_DIMS = (32, 64, 128)
_ARGTYPES = (_build.PTR,) * 8 + (_build.INT,) * 5 + (
    _build.FLOAT, _build.PTR, _build.PTR)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """q [B,H,D]; k,v [B,T,Hkv,D]; lengths [B] int32 -> out [B,H,D]."""
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
            f"{HEAD_DIMS}, at most 32 * 128 / D query heads per kv head)")
    nsplit = max(1, -(-t // _chunk()))
    part = torch.empty(b * h * nsplit * (d + 2), dtype=torch.float32, device=q.device)
    m_part, l_part = part[: b * h * nsplit], part[b * h * nsplit: 2 * b * h * nsplit]
    acc_part = part[2 * b * h * nsplit:]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
    fn = _build.function("decode_attention_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), b, h, hkv, t, d, float(scale), strides,
            _build.stream(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _chunk() -> int:
    fn = _build.function("decode_attention_chunk", ())
    return fn()

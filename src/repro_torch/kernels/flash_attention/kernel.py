"""Flash attention forward: the wrapper of the CUDA kernel in
`csrc/flash_attention.cu`.

Counterpart of `repro/kernels/flash_attention/kernel.py::flash_attention_fwd`
(forward only; the backward passes come with the training slice).  Unlike
the Pallas grid, the kernel takes an explicit `q_offset` and `kv_len`, masks
tails that are not a multiple of its tile, and reads strided views.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `flash_attention_fwd.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import attention_with_lse_ref

HEAD_DIMS = (32, 64, 128)
_ARGTYPES = (_build.PTR,) * 5 + (_build.INT,) * 8 + (
    _build.FLOAT, _build.PTR, _build.PTR)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None, causal: bool = True,
                        q_offset: int = 0, kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D]; k,v [B,Hkv,T,D] -> (out [B,H,S,D], lse [B,H,S] fp32).

    Query row i attends to columns j < kv_len (default T) and, when causal,
    j <= q_offset + i.  With q_offset = 0 and kv_len = S = T this is the
    Pallas kernel's top-left-aligned causal mask.  On CUDA, `out` is a
    [B,H,S,D] view of a contiguous [B,S,H,D] tensor.
    """
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return attention_with_lse_ref(q, k, v, scale, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.require(x, name, torch.bfloat16, q.device)
    if (k.shape != (b, hkv, t, d) or v.shape != k.shape or h % hkv
            or d not in HEAD_DIMS or not 0 <= kv_len <= t or q_offset < 0):
        raise ValueError(
            f"flash_attention_fwd: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len {kv_len}, "
            f"q_offset {q_offset} (head dim must be one of {HEAD_DIMS})")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                     *v.stride()[:3], *out.stride()[:3])
    fn = _build.function("flash_attention_fwd_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, s, d, kv_len, int(q_offset), int(causal),
            float(scale), strides, _build.stream(q))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0

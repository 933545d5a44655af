"""Plain PyTorch version of the flash-attention forward kernel (causal or
full GQA), the counterpart of `repro/kernels/flash_attention/ref.py`.

The mask is by absolute position: query row i sits at `q_offset + i` and
sees cache columns `j < kv_len` with `j <= q_offset + i` when causal.  The
default `q_offset = T - S` aligns the mask bottom-right, as the JAX oracle's
`tril(k=t-s)` does; the kernel wrapper passes its own `q_offset`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _masked_scores(q, k, scale, causal, q_offset, kv_len):
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = t - s
    if kv_len is None:
        kv_len = t
    qf = q.float().reshape(b, hkv, h // hkv, s, d)
    sc = torch.einsum("bgrsd,bgtd->bgrst", qf, k.float()) * scale
    cols = torch.arange(t, device=q.device)
    mask = (cols < kv_len)[None, :].expand(s, t)
    if causal:
        rows = q_offset + torch.arange(s, device=q.device)
        mask = mask & (cols[None, :] <= rows[:, None])
    return sc.masked_fill(~mask, float("-inf"))


def attention_with_lse_ref(q, k, v, scale: Optional[float] = None, *,
                           causal: bool = True, q_offset: Optional[int] = None,
                           kv_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D]; k,v [B,Hkv,T,D] -> (out [B,H,S,D] in q's dtype,
    lse [B,H,S] fp32), fp32 math."""
    b, h, s, d = q.shape
    sc = _masked_scores(q, k, scale, causal, q_offset, kv_len)
    out = torch.einsum("bgrst,bgtd->bgrsd", torch.softmax(sc, dim=-1), v.float())
    return (out.reshape(b, h, s, v.shape[-1]).to(q.dtype),
            torch.logsumexp(sc, dim=-1).reshape(b, h, s))


def attention_ref(q, k, v, scale: Optional[float] = None, *, causal: bool = True,
                  q_offset: Optional[int] = None, kv_len: Optional[int] = None
                  ) -> torch.Tensor:
    return attention_with_lse_ref(q, k, v, scale, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len)[0]


def lse_ref(q, k, scale: Optional[float] = None, *, causal: bool = True,
            q_offset: Optional[int] = None, kv_len: Optional[int] = None
            ) -> torch.Tensor:
    b, h, s, _ = q.shape
    sc = _masked_scores(q, k, scale, causal, q_offset, kv_len)
    return torch.logsumexp(sc, dim=-1).reshape(b, h, s)

"""Plain PyTorch versions of the flash-attention kernels (causal or full
GQA): the forward, the counterpart of `repro/kernels/flash_attention/ref.py`,
and the backward's two passes, which recompute P from the saved lse as the
Pallas passes do.

The mask is by absolute position: query row i sits at `q_offset + i` and
sees cache columns `j < kv_len` with `j <= q_offset + i` when causal.  The
default `q_offset = T - S` aligns the mask bottom-right, as the JAX oracle's
`tril(k=t-s)` does; the kernel wrapper passes its own `q_offset`.  v (and
so out, dO and dv) may have another head dim than q and k (MLA).
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


def _probs(q, k, lse, scale, causal, q_offset, kv_len):
    """P = exp(S - lse) as [B, Hkv, rep, S, T] fp32, exactly 0 where masked."""
    b, h, s, _ = q.shape
    hkv = k.shape[1]
    sc = _masked_scores(q, k, scale, causal, q_offset, kv_len)
    p = torch.exp(sc - lse.float().reshape(b, hkv, h // hkv, s, 1))
    return torch.where(torch.isfinite(sc), p, torch.zeros_like(p))


def _heads(x, hkv):
    b, h, s, d = x.shape
    return x.float().reshape(b, hkv, h // hkv, s, d)


def attention_bwd_dq_ref(q, k, v, out, do, lse, scale: Optional[float] = None, *,
                         causal: bool = True, q_offset: Optional[int] = None,
                         kv_len: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dq [B,H,S,D] in q's dtype, delta [B,H,S] fp32), fp32 math:
    delta = rowsum(out * do), dS = P (dO V^T - delta), dq = dS K * scale."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    delta = (out.float() * do.float()).sum(-1)
    p = _probs(q, k, lse, scale, causal, q_offset, kv_len)
    dp = torch.einsum("bgrsd,bgtd->bgrst", _heads(do, hkv), v.float())
    ds = p * (dp - delta.reshape(b, hkv, h // hkv, s, 1))
    dq = torch.einsum("bgrst,bgtd->bgrsd", ds, k.float()) * scale
    return dq.reshape(b, h, s, d).to(q.dtype), delta


def attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale: Optional[float] = None, *,
                          causal: bool = True, q_offset: Optional[int] = None,
                          kv_len: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dk, dv [B,Hkv,T,D] in k's and v's dtypes), fp32 math, summed over
    each kv head's query heads: dv = P^T dO, dk = dS^T Q * scale."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    p = _probs(q, k, lse, scale, causal, q_offset, kv_len)
    dof = _heads(do, hkv)
    dv = torch.einsum("bgrst,bgrsd->bgtd", p, dof)
    dp = torch.einsum("bgrsd,bgtd->bgrst", dof, v.float())
    ds = p * (dp - delta.float().reshape(b, hkv, h // hkv, s, 1))
    dk = torch.einsum("bgrst,bgrsd->bgtd", ds, _heads(q, hkv)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_ref(q, k, v, out, lse, do, scale: Optional[float] = None, *,
                      causal: bool = True, q_offset: Optional[int] = None,
                      kv_len: Optional[int] = None):
    """(dq, dk, dv): both passes, in the JAX `flash_attention_bwd` argument
    order."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    dq, delta = attention_bwd_dq_ref(q, k, v, out, do, lse, scale, **kw)
    dk, dv = attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale, **kw)
    return dq, dk, dv

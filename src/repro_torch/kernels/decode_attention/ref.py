"""Plain PyTorch version of the decode-attention kernel (the counterpart of
`repro/kernels/decode_attention/ref.py::decode_attention_ref`).

One difference by definition: a sequence of length 0 attends to nothing and
gets zeros, where the JAX oracle's softmax over an empty set gives NaN.  With
`return_lse` it also gives each row's log-sum-exp of the masked fp32 scores
(natural log; -inf at length 0) and the output in fp32, as the kernel does.
"""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, scale: Optional[float] = None, *,
                         return_lse: bool = False):
    """q [B,H,D] (one new token per sequence); k,v [B,T,Hkv,D]; lengths [B]
    (valid cache length per sequence, including the new token).
    Returns out [B,H,D] in q's dtype, fp32 math; with `return_lse` (out
    [B,H,D] fp32, lse [B,H] fp32)."""
    b, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, h // hkv, d)
    sc = torch.einsum("bgrd,btgd->bgrt", qf, k.float()) * scale
    lengths = lengths.to(q.device)
    mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]   # [B, T]
    sc = sc.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", w, v.float()).reshape(b, h, d)
    out = torch.where((lengths > 0)[:, None, None], out, torch.zeros_like(out))
    if return_lse:
        return out, torch.logsumexp(sc, dim=-1).reshape(b, h)
    return out.to(q.dtype)

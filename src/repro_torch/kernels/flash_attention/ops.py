"""Flash attention with its gradient: the counterpart of the `jax.custom_vjp`
in `repro/kernels/flash_attention/ops.py`.  The forward saves
(q, k, v, out, lse); the backward runs the dq and dk/dv passes."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .kernel import flash_attention_bwd, flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand any layout; the kernels take a contiguous last dim
        do = _build.kernel_layout(do)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, scale=ctx.scale,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = True
                    ) -> torch.Tensor:
    """q [B,H,S,D]; k [B,Hkv,S,D]; v [B,Hkv,S,DV] -> out [B,H,S,DV],
    differentiable in q, k and v.  The causal mask is aligned top-left
    (q_offset 0), as the Pallas kernels'."""
    return _FlashAttention.apply(q, k, v, scale, causal)

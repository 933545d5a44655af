"""The SSD scan with its gradient: `ssd_scan` and `ssd_scan_bwd` under one
`torch.autograd.Function`.  The JAX package has no such op (it trains
through the jnp `ssd_chunked` and XLA's autodiff); the mamba2 layer's
prompt branch goes through it, so that on a card both directions run the
kernels."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_scan, ssd_scan_bwd


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, B, C, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, B, C, h0)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a_log, B, C, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a_log, B, C, h0 = ctx.saved_tensors
        dy = (torch.zeros(x.shape, dtype=torch.float32, device=x.device) if dy is None
              else dy.contiguous())
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        dx, ddt, da_log, dB, dC, dh0 = ssd_scan_bwd(x, dt, a_log, B, C, h0, dy, dh_final,
                                                    chunk=ctx.chunk)
        return dx, ddt, da_log, dB, dC, dh0, None


def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ssd_scan`'s (y, h_final), differentiable in x, dt, a_log, B, C and
    h0; dh0 is None when h0 is."""
    return _SSDScan.apply(x, dt, a_log, B, C, h0, chunk)

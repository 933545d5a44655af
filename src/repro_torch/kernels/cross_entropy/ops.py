"""Fused cross-entropy with its gradient: `fused_ce_op` is the counterpart
of `repro/kernels/cross_entropy/ops.py::fused_ce_op` (the masked NLL summed
over rows), differentiable in the logits through the backward kernel."""
from __future__ import annotations

import torch

from .kernel import fused_ce, fused_ce_bwd


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask):
        nll, lse = fused_ce(logits, labels, mask)
        ctx.save_for_backward(logits, labels, mask, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, mask, lse = ctx.saved_tensors
        # the gradient of a sum arrives as an expanded (stride 0) row
        dlogits = fused_ce_bwd(logits, labels, mask, lse, g.float().contiguous())
        return dlogits, None, None


def fused_ce_op(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """logits [R, V]; labels [R]; mask [R] -> fp32 scalar sum of masked NLL."""
    return _FusedCE.apply(logits, labels, mask).sum()

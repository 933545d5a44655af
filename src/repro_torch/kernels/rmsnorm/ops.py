"""RMSNorm with its gradient: the forward and backward kernels under one
`torch.autograd.Function`.  The JAX package has no such op (its gradient
comes from XLA autodiff of jnp code); the model's RMS norms go through it
so that on a card both directions run the kernels.  The forward saves x as
the caller passed it (MLA's kv_norm: a slice of wider rows), and the
backward kernel reads it at that pitch as the forward did."""
from __future__ import annotations

import torch

from .kernel import rmsnorm, rmsnorm_bwd


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()      # the kernel reads [rows, D] rows
        dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
               ) -> torch.Tensor:
    """x [..., D]; scale [D] -> [..., D], differentiable in both."""
    return _RMSNorm.apply(x, scale, eps)

"""Plain PyTorch versions of the RMSNorm kernels (`rmsnorm_ref` is the
counterpart of `repro/kernels/rmsnorm/ref.py::rmsnorm_ref`)."""
from typing import Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """x [..., D] (any strides, such as a slice of wider rows); scale [D]
    -> [..., D] in x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale): autograd through `rmsnorm_ref`, as JAX differentiates
    its jnp reference."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        dx, dscale = torch.autograd.grad(rmsnorm_ref(xr, sr, eps), (xr, sr), dy)
    return dx, dscale

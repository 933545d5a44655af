"""RMSNorm: the wrapper of the CUDA kernel in `csrc/rmsnorm.cu`.

Counterpart of `repro/kernels/rmsnorm/kernel.py::rmsnorm`.  A CPU tensor
takes the plain version `rmsnorm_ref`; a CUDA tensor launches the kernel or
raises.  `rmsnorm.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rmsnorm_ref

_ARGTYPES = (_build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT,
             _build.FLOAT, _build.PTR)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x [..., D]; scale [D] -> [..., D] in x's dtype (fp32 math)."""
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps)
    d = x.shape[-1]
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(scale, "scale", torch.bfloat16, x.device)
    if not x.is_contiguous() or scale.shape != (d,) or d % 8:
        raise ValueError(f"rmsnorm: needs contiguous x [..., D] with D % 8 == 0 "
                         f"and scale [D]; got {tuple(x.shape)}, {tuple(scale.shape)}")
    out = torch.empty_like(x)
    fn = _build.function("rmsnorm_bf16", _ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
            float(eps), _build.stream(x))
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0

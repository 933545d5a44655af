"""Plain PyTorch version of the RMSNorm kernel (the counterpart of
`repro/kernels/rmsnorm/ref.py::rmsnorm_ref`)."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)

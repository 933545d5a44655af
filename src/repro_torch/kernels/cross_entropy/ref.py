"""Plain PyTorch versions of the fused cross-entropy kernels (`ce_ref` is
the counterpart of `repro/kernels/cross_entropy/ref.py::ce_ref`)."""
from typing import Tuple

import torch


def ce_ref(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
           ) -> torch.Tensor:
    """logits [R, V] (any dtype); labels [R] int; mask [R] f32 -> sum over
    rows of the masked NLL (fp32 scalar)."""
    return ce_rows_ref(logits, labels, mask)[0].sum()


def ce_rows_ref(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (nll * mask [R] fp32, lse [R] fp32): what the forward kernel
    writes."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    pick = torch.gather(lf, 1, labels.long()[:, None])[:, 0]
    return (lse - pick) * mask, lse


def ce_bwd_ref(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dlogits [R, V] in the logits' dtype, fp32 math:
    g[r] mask[r] (softmax(logits[r]) - onehot(labels[r]))."""
    p = torch.exp(logits.float() - lse[:, None])
    p.scatter_add_(1, labels.long()[:, None], -torch.ones_like(p[:, :1]))
    return (p * (g * mask)[:, None]).to(logits.dtype)

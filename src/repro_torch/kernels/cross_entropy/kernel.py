"""Fused masked cross-entropy, forward and backward: the wrappers of the
CUDA kernels in `csrc/cross_entropy.cu`.

`fused_ce` is the counterpart of `repro/kernels/cross_entropy/kernel.py::fused_ce`
(whose per-row values the Pallas kernel writes before summing them); it
returns the rows, and lse for the backward, which has no Pallas
counterpart.  The vocab need not be a multiple of any tile.  A fake tensor
takes the abstract path (`kernels/abstract.py`: outputs without a launch,
counted in `<wrapper>.traced`) after the checks a CUDA tensor meets; a CPU
tensor the plain version; a CUDA
tensor launches the kernel or raises.  `<wrapper>.launches` counts kernel
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..abstract import FakeTensor, traced
from .ref import ce_bwd_ref, ce_rows_ref

_FWD_ARGTYPES = (_build.PTR,) * 5 + (_build.INT, _build.INT, _build.PTR)
_BWD_ARGTYPES = (_build.PTR,) * 6 + (_build.INT, _build.INT, _build.PTR)


def _check(name, logits, labels, mask, *rows) -> None:
    _build.require(logits, "logits", torch.bfloat16, logits.device)
    # the [R] rows are read one value at a time: contiguous, any alignment
    _build.require(labels, "labels", torch.int64, logits.device, vector=False)
    for arg, t in (("mask", mask), *rows):
        _build.require(t, arg, torch.float32, logits.device, vector=False)
    r = logits.shape[0]
    if (logits.dim() != 2 or not logits.is_contiguous()
            or any(t.shape != (r,) for t in (labels, mask, *(t for _, t in rows)))):
        raise ValueError(f"{name}: needs contiguous logits [R, V] and [R] rows; got "
                         f"{tuple(logits.shape)}, labels {tuple(labels.shape)}, "
                         f"mask {tuple(mask.shape)}")


def fused_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] bf16; labels [R] int64 in [0, V); mask [R] fp32 ->
    (nll * mask [R] fp32, lse [R] fp32)."""
    fake = isinstance(logits, FakeTensor)
    if not (fake or logits.is_cuda):
        return ce_rows_ref(logits, labels, mask)
    _check("fused_ce", logits, labels, mask)
    if fake:                            # logits read; labels, mask read, nll, lse written
        r = logits.shape[0]
        return traced(fused_ce, (logits.new_empty((r,), dtype=torch.float32),
                                 logits.new_empty((r,), dtype=torch.float32)),
                      4 * logits.numel(), logits.numel() * logits.element_size() + r * 20)
    r, v = logits.shape
    nll = torch.empty((r,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    fn = _build.function("ce_fwd_bf16", _FWD_ARGTYPES)
    rc = fn(logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), r, v, _build.stream(logits))
    _build.check(rc, "fused_ce")
    fused_ce.launches += 1
    return nll, lse


fused_ce.launches = 0
fused_ce.traced = 0


def fused_ce_bwd(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of `fused_ce`'s rows weighted by g [R] fp32:
    dlogits [R, V] bf16 = g mask (softmax(logits) - onehot(labels))."""
    fake = isinstance(logits, FakeTensor)
    if not (fake or logits.is_cuda):
        return ce_bwd_ref(logits, labels, mask, lse, g)
    _check("fused_ce_bwd", logits, labels, mask, ("lse", lse), ("g", g))
    if fake:                            # logits read, dlogits written, four [R] rows read
        return traced(fused_ce_bwd, logits.new_empty(logits.shape), 4 * logits.numel(),
                      2 * logits.numel() * logits.element_size() + logits.shape[0] * 20)
    r, v = logits.shape
    dlogits = torch.empty_like(logits)
    fn = _build.function("ce_bwd_bf16", _BWD_ARGTYPES)
    rc = fn(logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dlogits.data_ptr(), r, v, _build.stream(logits))
    _build.check(rc, "fused_ce_bwd")
    fused_ce_bwd.launches += 1
    return dlogits


fused_ce_bwd.launches = 0
fused_ce_bwd.traced = 0

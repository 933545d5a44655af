"""RMSNorm forward and backward: the wrappers of the CUDA kernels in
`csrc/rmsnorm.cu`.

`rmsnorm` is the counterpart of `repro/kernels/rmsnorm/kernel.py::rmsnorm`;
`rmsnorm_bwd` has no Pallas counterpart (JAX differentiates the jnp
reference) and gives the gradients of both inputs.  A fake tensor takes
the abstract path (`kernels/abstract.py`: outputs without a launch, counted
in `<wrapper>.traced`); a CPU tensor the plain version; a CUDA tensor
launches the kernel or raises.  `<wrapper>.launches` counts kernel launches.

Both directions read x's rows in place at any uniform pitch (`row_pitch`):
a slice of the first D columns of wider rows, such as MLA's `kv_norm` input
(512 of each 576-column projection row), takes one launch and no copy.  The
forward's output, the backward's dy and its dx are contiguous.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import _build
from ..abstract import FakeTensor, traced
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

_ARGTYPES = (_build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT, _build.INT,
             _build.FLOAT, _build.PTR)
_BWD_ARGTYPES = (_build.PTR,) * 7 + (_build.INT,) * 4 + (_build.FLOAT, _build.PTR)
# the forward holds a row in the registers of at most 512 threads, at most
# eight 16-byte vectors each
MAX_D = 32768
# the backward holds a row in the registers of at most 512 threads, two
# 16-byte vectors of x and of dy each (the widest d_model of the configs)
MAX_BWD_D = 8192
# the backward's partial dscale rows: at most one per block the card holds at
# once, four 512-thread blocks an SM of an H100 (132 SMs); the kernel takes
# as many blocks as fit
_BWD_BLOCKS = 4 * 132
# the backward's grid barrier: two uint32 per (device, stream), zero at first
# use; each launch leaves the count at zero and advances the generation
_BARRIERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _check(x: torch.Tensor, scale: torch.Tensor, name: str) -> None:
    d = x.shape[-1]
    if scale.shape != (d,) or d % 8:
        raise ValueError(f"{name}: needs x [..., D] with D % 8 == 0 and scale [D]; "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}")


def row_pitch(x: torch.Tensor) -> int:
    """The elements from one row of x [..., D] to the next, read as [rows,
    D]: x's leading dims must step over its rows at one uniform pitch >= D
    (the first D columns of wider rows qualify, a transpose does not)."""
    if x.is_contiguous():
        return x.shape[-1]
    pitch, span = None, 1
    for size, st in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            continue
        if pitch is None:
            pitch = st
        elif st != pitch * span:
            raise ValueError(f"rmsnorm: x's rows {tuple(x.shape)} (strides {x.stride()}) "
                             "are not at one uniform pitch")
        span *= size
    pitch = x.shape[-1] if pitch is None else pitch
    if pitch < x.shape[-1]:
        raise ValueError(f"rmsnorm: rows overlap (pitch {pitch} < D {x.shape[-1]})")
    return pitch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x [..., D], its rows at any uniform pitch; scale [D] -> contiguous
    [..., D] in x's dtype (fp32 math)."""
    if isinstance(x, FakeTensor):       # 4 flops an element; x read, out written, scale
        return traced(rmsnorm, x.new_empty(x.shape), 4 * x.numel(),
                      2 * x.numel() * x.element_size() + scale.numel() * scale.element_size())
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps)
    d = x.shape[-1]
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(scale, "scale", torch.bfloat16, x.device)
    _check(x, scale, "rmsnorm")
    if d > MAX_D:
        raise ValueError(f"rmsnorm: D <= {MAX_D}; got {d}")
    pitch = row_pitch(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    fn = _build.function("rmsnorm_bf16", _ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d, pitch,
            float(eps), _build.stream(x))
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
rmsnorm.traced = 0


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D], its rows at any uniform pitch, as the forward read them;
    dy [..., D] contiguous; scale [D] -> (dx [..., D] contiguous, dscale
    [D]), each in its input's dtype (fp32 math; dscale summed over rows in a
    fixed order).  One launch: a cooperative grid whose blocks meet at a
    grid barrier (`csrc/rmsnorm.cu`)."""
    if isinstance(x, FakeTensor):       # 10 flops an element; x, dy read, dx written
        return traced(rmsnorm_bwd, (x.new_empty(x.shape), scale.new_empty(scale.shape)),
                      10 * x.numel(), 3 * x.numel() * x.element_size()
                      + 2 * scale.numel() * scale.element_size())
    if not x.is_cuda:
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    d = x.shape[-1]
    for name, t in (("x", x), ("scale", scale), ("dy", dy)):
        _build.require(t, name, torch.bfloat16, x.device)
    _check(x, scale, "rmsnorm_bwd")
    if dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"rmsnorm_bwd: dy must be contiguous and shaped like x "
                         f"{tuple(x.shape)}; got {tuple(dy.shape)}")
    if d > MAX_BWD_D:
        raise ValueError(f"rmsnorm_bwd: D <= {MAX_BWD_D}; got {d}")
    pitch = row_pitch(x)
    rows = x.numel() // d
    n_part = max(1, min(rows, _BWD_BLOCKS))
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty_like(scale)
    partial = torch.empty((n_part, d), dtype=torch.float32, device=x.device)
    st = _build.stream(x)
    barrier = _BARRIERS.get((x.device.index, st))
    if barrier is None:
        barrier = _BARRIERS[(x.device.index, st)] = torch.zeros(
            2, dtype=torch.int32, device=x.device)
    fn = _build.function("rmsnorm_bwd_bf16", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), barrier.data_ptr(), rows, d, pitch,
            n_part, float(eps), st)
    _build.check(rc, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
rmsnorm_bwd.traced = 0


"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel in
`csrc/ssd_scan.cu`.

Counterpart of `repro/kernels/ssd_scan/kernel.py::ssd_scan`, computing the
function of `repro/models/ssm.py::ssd_chunked`: it starts from a state `h0`
and takes any sequence length, and returns y in fp32, as the model adds
D x to it in fp32.  The kernel's chunk length is its own (64 rows); `chunk`
is that of the plain version.  There is no backward yet: under grad mode an
input that requires grad is an error, not a silently gradient-less output.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `ssd_scan.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssd_scan_ref

HEAD_DIMS = (16, 32, 64)            # P
STATE_DIMS = (16, 32, 64, 128)      # N
_ARGTYPES = (_build.PTR,) * 9 + (_build.INT,) * 5 + (_build.PTR,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P] bf16; dt [B,S,H] fp32; a_log [H] fp32; B, C [B,S,N] bf16;
    h0 [B,H,P,N] fp32 or None (zeros) -> (y [B,S,H,P] fp32,
    h_final [B,H,P,N] fp32).  x, B and C may be strided views whose last
    dim is contiguous (the model's slices of one conv output)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a_log, B, C, h0)):
        raise NotImplementedError(
            "ssd_scan has no backward yet (ROADMAP.md Queue 1 item 3, SSM "
            "training): call it under torch.no_grad() or inference_mode()")
    if not x.is_cuda:
        return ssd_scan_ref(x, dt, a_log, B, C, chunk=chunk, h0=h0)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    for name, t in (("x", x), ("B", B), ("C", C)):
        _build.require(t, name, torch.bfloat16, dev)
    for name, t in (("dt", dt), ("a_log", a_log)):
        _build.require(t, name, torch.float32, dev, vector=False)
    if h0 is not None:
        _build.require(h0, "h0", torch.float32, dev, vector=False)
    if (s < 1 or p not in HEAD_DIMS or n not in STATE_DIMS
            or dt.shape != (b, s, h) or a_log.shape != (h,)
            or B.shape != (b, s, n) or C.shape != B.shape
            or (h0 is not None and h0.shape != (b, h, p, n))):
        raise ValueError(
            f"ssd_scan: unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a_log {tuple(a_log.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} (S >= 1, head dim P one "
            f"of {HEAD_DIMS}, state dim N one of {STATE_DIMS})")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 7)(*x.stride()[:3], *B.stride()[:2], *C.stride()[:2])
    fn = _build.function("ssd_scan_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            strides, b, s, h, p, n, _build.stream(x))
    _build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0

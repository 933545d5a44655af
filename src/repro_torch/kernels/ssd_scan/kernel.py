"""Mamba2 SSD chunked scan: the wrappers of the CUDA kernels in
`csrc/ssd_scan.cu` (forward) and `csrc/ssd_scan_bwd.cu` (backward).

`ssd_scan` is the counterpart of `repro/kernels/ssd_scan/kernel.py::ssd_scan`,
computing the function of `repro/models/ssm.py::ssd_chunked`: it starts from
a state `h0` and takes any sequence length, and returns y in fp32, as the
model adds D x to it in fp32.  Under grad mode it refuses an input that
requires grad (a silently gradient-less output would be wrong): the
differentiable scan is `ops.py::ssd_scan_op`.  `ssd_scan_bwd` computes the
gradients of the scan (no TPU counterpart: JAX differentiates the jnp scan).
The kernels' chunk length is their own (64 rows); `chunk` is that of the
plain versions.

A fake tensor takes the abstract path (`kernels/abstract.py`: outputs
without a launch, counted in `<wrapper>.traced`, the work by `fwd_work` and
`bwd_work`); a CPU tensor the plain version; a CUDA tensor launches the
kernel or raises.  `ssd_scan.launches` and `ssd_scan_bwd.launches` count calls that
launch (the backward makes three CUDA launches a call: the state walkers, the
gradients, da_log's sum).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..abstract import FakeTensor, traced
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

HEAD_DIMS = (16, 32, 64)            # P
STATE_DIMS = (16, 32, 64, 128)      # N
KERNEL_CHUNK = 64                   # rows a chunk in both kernels
_ARGTYPES = (_build.PTR,) * 9 + (_build.INT,) * 5 + (_build.PTR,)


def fwd_work(b, s, h, p, n, chunk=KERNEL_CHUNK) -> tuple:
    """(bytes, tensor-core operations) of the SSD scan's forward.  Bytes: x
    (bf16) and dt read, y (fp32) written, a_log, B and C read, h0 read and
    h_final written (fp32).  Operations: the kernel runs its products on the
    tensor cores in bf16, each fp32 operand split into hi + lo; per (batch,
    head, 64-row chunk) C B^T (1 product, L L N), C h^T (2, L P N), att (x
    dt) (3, L L P) and the state update (2, P N L), with P padded to 64."""
    tok_heads, nc, pk = b * s * h, -(-s // chunk), max(p, 64)
    nbytes = (tok_heads * p * (2 + 4) + tok_heads * 4 + h * 4 + 2 * b * s * n * 2
              + 2 * b * h * p * n * 4)
    ops = 2 * b * h * nc * (chunk * chunk * n + 2 * chunk * pk * n + 3 * chunk * chunk * pk
                            + 2 * pk * n * chunk)
    return nbytes, ops


def bwd_work(b, s, h, p, n, chunk=KERNEL_CHUNK) -> tuple:
    """(bytes, tensor-core operations, fp32 operations) the SSD scan's
    backward needs.  Bytes: x, dy, B, C, dt read and dx, dB, dC, ddt written
    once.  Operations: the products of `ssd_scan_bwd_ref`'s formulas, the
    intra-chunk ones over the causal pairs j <= i only (T = L(L+1)/2 per
    chunk), two operations a multiply-add.  Per (batch, head, chunk): dy u^T
    and att^T dy (T P each), the E-weighted sums of C and of B for dB and dC
    (T N each), and the chunk's state update, its chain share, G B_j, u^T G
    and H^T dy (L P N each); per (batch, chunk) C B^T (T N).
    The tensor-core count is that of bf16 operands with every fp32 operand
    split into hi + lo, as the kernels run their products: fp32 x fp32
    three products (att^T dy, H^T dy), fp32 x bf16 two (the E-weighted sums
    against C and B, the state update and chain share against B and C,
    G B_j, and dy u^T and u^T G, whose u = dt x is the exact bf16 x scaled
    by a row's dt), bf16 x bf16 one (C B^T).  The fp32 count is each
    product once, as fp32 CUDA cores would run it: a yardstick."""
    nc = -(-s // chunk)
    tri, lpn = chunk * (chunk + 1) // 2, chunk * p * n
    nbytes = b * s * h * p * (2 + 2 + 4) + 4 * b * s * n * 2 + 2 * b * s * h * 4 + 2 * h * 4
    cbt = b * nc * tri * n
    tc_macs = b * h * nc * (tri * (2 * p + 3 * p + 2 * n + 2 * n) + lpn * (2 + 2 + 2 + 2 + 3)) + cbt
    f32_macs = b * h * nc * (tri * (2 * p + 2 * n) + 5 * lpn) + cbt
    return nbytes, 2 * tc_macs, 2 * f32_macs


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
            "ssd_scan does not differentiate: call ssd_scan_op (the autograd op "
            "whose backward is ssd_scan_bwd), or this under torch.no_grad()")
    if isinstance(x, FakeTensor):
        b, s, h, p = x.shape
        n = B.shape[-1]
        nbytes, ops = fwd_work(b, s, h, p, n)
        return traced(ssd_scan, (x.new_empty((b, s, h, p), dtype=torch.float32),
                                 x.new_empty((b, h, p, n), dtype=torch.float32)), ops, nbytes)
    if not x.is_cuda:
        return ssd_scan_ref(x, dt, a_log, B, C, chunk=chunk, h0=h0)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    _check("ssd_scan", x, dt, a_log, B, C, h0=h0)
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
ssd_scan.traced = 0


def _check(name, x, dt, a_log, B, C, **states) -> None:
    """Raise unless the kernels take these tensors: x, B and C bf16 views
    whose last dim is contiguous, the rest fp32 and contiguous, P in
    HEAD_DIMS, N in STATE_DIMS, S >= 1.  `states` are [B,H,P,N] or None."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    for nm, t in (("x", x), ("B", B), ("C", C)):
        _build.require(t, nm, torch.bfloat16, dev)
    for nm, t in (("dt", dt), ("a_log", a_log)):
        _build.require(t, nm, torch.float32, dev, vector=False)
    for nm, t in states.items():
        if t is not None:
            _build.require(t, nm, torch.float32, dev, vector=False)
    if (s < 1 or p not in HEAD_DIMS or n not in STATE_DIMS
            or dt.shape != (b, s, h) or a_log.shape != (h,)
            or B.shape != (b, s, n) or C.shape != B.shape
            or any(t is not None and t.shape != (b, h, p, n) for t in states.values())):
        raise ValueError(
            f"{name}: unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a_log {tuple(a_log.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            + ", ".join(f"{k} {None if t is None else tuple(t.shape)}"
                        for k, t in states.items())
            + f" (S >= 1, head dim P one of {HEAD_DIMS}, state dim N one of {STATE_DIMS})")


_BWD_ARGTYPES = (_build.PTR,) * 16 + (_build.INT,) * 5 + (_build.PTR,)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor],
                 dy: torch.Tensor, dh_final: Optional[torch.Tensor], *, chunk: int = 256):
    """The gradients of `ssd_scan` at (x, dt, a_log, B, C, h0), given dy
    [B,S,H,P] fp32 on y and dh_final [B,H,P,N] fp32 (or None: zeros) on the
    final state -> (dx bf16, ddt fp32, da_log fp32, dB bf16, dC bf16, dh0
    fp32 or None when h0 is None), as `ssd_scan_bwd_ref`.  The inputs are
    those `ssd_scan` takes; dy and dh_final are contiguous.  Deterministic:
    the sums over heads, batches and chunks run in a fixed order."""
    if isinstance(x, FakeTensor):
        b, s, h, p = x.shape
        n = B.shape[-1]
        nbytes, ops, _ = bwd_work(b, s, h, p, n)
        f32 = dict(dtype=torch.float32)
        outs = (x.new_empty((b, s, h, p)), x.new_empty((b, s, h), **f32),
                x.new_empty((h,), **f32), B.new_empty((b, s, n)), B.new_empty((b, s, n)),
                None if h0 is None else x.new_empty((b, h, p, n), **f32))
        return traced(ssd_scan_bwd, outs, ops, nbytes)
    if not x.is_cuda:
        return ssd_scan_bwd_ref(x, dt, a_log, B, C, h0, dy, dh_final, chunk=chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    _check("ssd_scan_bwd", x, dt, a_log, B, C, h0=h0, dh_final=dh_final)
    _build.require(dy, "dy", torch.float32, dev, vector=False)
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    dx = torch.empty((b, s, h, p), dtype=torch.bfloat16, device=dev)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    da_log = torch.empty((h,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, n), dtype=torch.bfloat16, device=dev)
    dC = torch.empty((b, s, n), dtype=torch.bfloat16, device=dev)
    dh0 = None if h0 is None else torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    # the walkers' images of each chunk's entering state, of the gradient on
    # its leaving state and of its dy (bf16 hi + lo each), and da_log's shares
    nc = -(-s // KERNEL_CHUNK)
    ws = torch.empty(b * h * nc * (2 * p * n + KERNEL_CHUNK * p) + b * nc * h,
                     dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 7)(*x.stride()[:3], *B.stride()[:2], *C.stride()[:2])
    fn = _build.function("ssd_scan_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            0 if h0 is None else h0.data_ptr(), dy.data_ptr(),
            0 if dh_final is None else dh_final.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_log.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            0 if dh0 is None else dh0.data_ptr(), ws.data_ptr(), strides, b, s, h, p, n,
            _build.stream(x))
    _build.check(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da_log, dB, dC, dh0


ssd_scan_bwd.launches = 0
ssd_scan_bwd.traced = 0

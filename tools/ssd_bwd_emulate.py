#!/usr/bin/env python3
"""The SSD-scan backward kernel's arithmetic, emulated on the CPU, against
fp64 autograd of the plain scan.

    python3 tools/ssd_bwd_emulate.py [--seq 2048] [--heads 24] [--batch 1]

Runs `csrc/ssd_scan_bwd.cu`'s products as the tensor cores do them: each
fp32 operand split into bf16 hi + lo (hi rounded where a lo x lo term is
dropped, truncated where lo meets an exact bf16 operand), each product of
bf16 values exact and summed in fp32; the walkers' state, gradient and dy
images kept as hi + lo; C B^T, the decays, dcum and its reverse cumsum in
fp32.  Prints one JSON line: for mamba2-130m's widths (P 64, N 128) at
`--seq` tokens from no state (`train`) and at `--seq` + 1 tokens from an
N(0, 0.3^2) state with a gradient on the final state (`tail`), the
relative L2 error of each gradient against fp64 autograd of
`ssd_scan_ref` (bf16 outputs against the fp64 gradient rounded to bf16,
as `chip_smoke.py`), for the split operands and for the same products with
every lo term dropped (`no_lo`, what `tools/kernel_ab.py --make-control`
builds), and the plain version's at 64-row chunks.  Inputs are
`chip_smoke.ssd_inputs`'s.  CPU only; batch 1 at 2048 tokens takes ~10 s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402

L = 64                          # the kernels' chunk


def _bf16(x):
    return x.to(torch.bfloat16).float()


def split(x, rounded=True, lo=True):
    """x as bf16 hi + lo (fp32 tensors holding bf16 values); without lo, hi
    rounded and lo 0, as the `--make-control` copy's `split_bf16x2`."""
    if not lo:
        return _bf16(x), torch.zeros_like(x)
    hi = _bf16(x) if rounded else (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, _bf16(x - hi)


def mm3(a, bh, bl, lo):
    """fp32 a (split, hi rounded) times b = bh + bl: lo x lo dropped."""
    ah, al = split(a, lo=lo)
    return ah @ bh + ah @ bl + al @ bh


def mm2(a, b, lo):
    """fp32 a (split, hi truncated) times an exact bf16 b."""
    ah, al = split(a, rounded=False, lo=lo)
    return ah @ b + al @ b


def emulate(x, dt, a_log, B, C, h0, dy, dhf, lo=True):
    b, s, nh, p = x.shape
    n = B.shape[-1]
    pad = -s % L
    nc = (s + pad) // L
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dyf = F.pad(dy, (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt, (0, 0, 0, pad))
    Bf, Cf = F.pad(B.float(), (0, 0, 0, pad)), F.pad(C.float(), (0, 0, 0, pad))
    A = -torch.exp(a_log)
    dx = torch.zeros(b, nc * L, nh, p)
    ddt = torch.zeros(b, nc * L, nh)
    dB, dC = torch.zeros(b, nc * L, n), torch.zeros(b, nc * L, n)
    da = torch.zeros(nh)
    dh0 = torch.zeros(b, nh, p, n)
    upper = torch.triu(torch.ones(L, L, dtype=torch.bool))     # [j, i]: i >= j
    for bb in range(b):
        rows = lambda t, c: t[bb, c * L:(c + 1) * L]          # noqa: E731
        rf = {}
        for hh in range(nh):
            for c in range(nc):
                d = rows(dtf, c)[:, hh]
                cum = torch.cumsum(d * A[hh], 0)
                rf[hh, c] = (d, cum, torch.exp(cum[-1] - cum), torch.exp(cum), torch.exp(cum[-1]))
        # the walkers: the images of the state entering each chunk, of the
        # gradient on the state leaving it, and of the chunk's dy
        himg, gimg, dyimg = {}, {}, {}
        for hh in range(nh):
            h = torch.zeros(p, n) if h0 is None else h0[bb, hh].clone()
            for c in range(nc):
                himg[hh, c] = split(h, lo=lo)
                d, _, w, _, dec = rf[hh, c]
                h = dec * h + mm2((rows(xf, c)[:, hh] * (d * w)[:, None]).T, rows(Bf, c), lo)
            g = torch.zeros(p, n) if dhf is None else dhf[bb, hh].clone()
            for c in reversed(range(nc)):
                gimg[hh, c] = split(g, lo=lo)
                dyimg[hh, c] = split(rows(dyf, c)[:, hh], lo=lo)
                _, _, _, ec, dec = rf[hh, c]
                g = dec * g + mm2((rows(dyf, c)[:, hh] * ec[:, None]).T, rows(Cf, c), lo)
            dh0[bb, hh] = g
        # the gradient pass: one (batch, chunk), the heads in order
        for c in range(nc):
            Bs, Cs = rows(Bf, c), rows(Cf, c)
            cbt = Bs @ Cs.T                                      # [j, i]
            dBc, dCc = torch.zeros(L, n), torch.zeros(L, n)
            for hh in range(nh):
                d, cum, w, ec, dec = rf[hh, c]
                xs = rows(xf, c)[:, hh]
                dyh, dyl = dyimg[hh, c]
                gh_, gl_ = gimg[hh, c]
                hh_, hl_ = himg[hh, c]
                dut = (xs @ dyh.T + xs @ dyl.T) * d[:, None]     # u_j . dy_i
                et = torch.where(upper, torch.exp(cum[None, :] - cum[:, None]), torch.zeros(()))
                att, edt = et * cbt, et * dut
                m = att * dut
                du_i = mm3(att, dyh, dyl, lo)
                dus = Bs @ gh_.T + Bs @ gl_.T
                dBc += mm3(xs * (w * d)[:, None], gh_, gl_, lo) + mm2(edt, Cs, lo)
                dCc += mm3((dyh + dyl) * ec[:, None], hh_, hl_, lo) + mm2(edt.T, Bs, lo)
                dci = ec * ((dyh + dyl) * (Cs @ hh_.T + Cs @ hl_.T)).sum(1)
                du = du_i + w[:, None] * dus
                st = w * d * (xs * dus).sum(1)
                dcum = m.sum(0) - m.sum(1) + dci - st
                dcum[-1] += st.sum() + dec * ((gh_ + gl_) * (hh_ + hl_)).sum()
                rc = torch.flip(torch.cumsum(torch.flip(dcum, (0,)), 0), (0,))
                ddt[bb, c * L:(c + 1) * L, hh] = (du * xs).sum(1) + A[hh] * rc
                da[hh] += (d * A[hh] * rc).sum()
                dx[bb, c * L:(c + 1) * L, hh] = d[:, None] * du
            dB[bb, c * L:(c + 1) * L], dC[bb, c * L:(c + 1) * L] = dBc, dCc
    return (dx[:, :s].to(torch.bfloat16), ddt[:, :s], da, dB[:, :s].to(torch.bfloat16),
            dC[:, :s].to(torch.bfloat16), None if h0 is None else dh0)


def case(batch, s, heads, h0_scale, with_dhf, seed=13, p=64, n=128) -> dict:
    rng = np.random.default_rng(seed)
    args, h0 = cs.ssd_inputs(cs.bf16_normal(rng, "cpu"), rng, "cpu", batch, s, heads, p, n,
                             h0_scale)
    h0 = h0 if h0_scale else None
    dy = torch.from_numpy(rng.standard_normal((batch, s, heads, p), dtype=np.float32))
    dhf = (torch.from_numpy(rng.standard_normal((batch, heads, p, n), dtype=np.float32))
           if with_dhf else None)
    exact = cs.ssd_grads_f64(ssd_scan_ref, args, h0, dy, dhf, chunk=256)
    names = ("dx", "ddt", "da_log", "dB", "dC", "dh0")

    def rel(got):
        return {nm: cs.rel_l2(g, e.to(g.dtype)) for nm, g, e in zip(names, got, exact)
                if g is not None}

    return {"S": s, "split": rel(emulate(*args, h0, dy, dhf)),
            "no_lo": rel(emulate(*args, h0, dy, dhf, lo=False)),
            "plain_chunk_64": rel(ssd_scan_bwd_ref(*args, h0, dy, dhf, chunk=L))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps({"train": case(args.batch, args.seq, args.heads, 0.0, False),
                      "tail": case(args.batch, args.seq + 1, args.heads, 0.3, True)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time kernels of one source tree on one NVIDIA card, or run its mamba2
prefill-vs-decode cross-check.

    python3 tools/kernel_ab.py [--src DIR]                    # timings
    python3 tools/kernel_ab.py [--src DIR] --ssm-cross-check  # the cross-check
    python3 tools/kernel_ab.py [--src DIR] --groups G [G ...] # some of GROUPS only
    python3 tools/kernel_ab.py [--src DIR] --make-control OUT # no card needed
    python3 tools/kernel_ab.py [--src DIR] --make-variant NAME OUT   # no card needed

Imports `repro_torch` from DIR (default: this checkout's `src`), so that two
trees, such as a parent commit unpacked into a git-ignored directory and
this one, can be timed in turns in one call: each builds its own kernels
into its own `build/`.  The inputs, timer and accuracy measures are
`chip_smoke.py`'s, at its shapes:

* `flash128`: the chatglm3-6b train step's attention (B 8, H 32, Hkv 2, S
  512, D 128, causal): the dq pass, the whole flash backward (dq, then
  dk/dv) and SDPA's backward; and the dq pass at rep 1 (H 32 = Hkv) of the
  same shape;
* `head_dim_80`: stablelm-3b's head dim 80 (H 32, MHA, S 512, causal): the
  forward at the serve prefill (B 4, k and v read from the 1024-row cache)
  and the train step (B 8), and at the train step the dq and dk/dv passes
  and the whole backward, as the tree's wrappers take D 80 (padded, or
  native), each checked against its plain version;
* `rmsnorm`: the RMSNorm forward at the serve prefill's [2048, 4096], the
  train step's [4096, 4096] and the decode steps' [4, 4096] and [4, 768],
  each checked against its plain version at `chip_smoke.TOL_RMSNORM`, and
  the RMSNorm backward at the train step's [4096, 4096] and, where the
  tree takes it, at jamba's [4096, 16384] (checked by
  `chip_smoke.rmsnorm_bwd_check`);
* `decode`: decode attention at the serve runs' lengths (513-576 of a 1024-row cache):
  chatglm3-6b's B 4, H 32, Hkv 2, D 128 and, where the tree takes head dim
  80, stablelm-3b's B 4, H 32, Hkv 32, D 80; at every cluster size where
  the tree's wrapper takes one;
* `ssd`: the mamba2-130m prefill's SSD scan (4 x 8192 tokens, x/B/C strided as the
  model passes them, zero state), with the largest error of y and of the
  final state against the plain version, and the relative L2 error of the
  kernel and of the plain version against the fp64 recurrence, with whether
  the kernel's exceeds `chip_smoke.TOL_SSD_REL_L2`, there and at S = 8193
  from an N(0, 0.3^2) state;
* `ssd_bwd`: the SSD scan's backward at mamba2-130m's train step (8 x 2048
  tokens, strided as the model passes them, no state, as `chip_smoke.py`'s
  row), with its excess over `chip_smoke.TOL_BF16` against the plain
  version at the kernel's 64-row chunks, every gradient's relative L2 error
  against fp64 autograd of the plain scan (bf16 outputs against the fp64
  gradient rounded to bf16, as `chip_smoke.py`), and the device time of
  each of its CUDA kernels a call under `torch.profiler` (skipped in a tree
  without it).

`--ssm-cross-check` runs `chip_smoke.py`'s cross_check_ssm instead: full-
width mamba2-130m (weights seed 0, prompts seed 5), the last logits of an
8193-token prefill against an 8192-token prefill plus one decode step, as
max |diff| over max |logit|.  `--make-control OUT` writes a copy of the
tree's `src` to OUT whose split bf16 operands drop every lo term (hi
rounded to nearest: plain bf16 operands), the control that the split is
measured against: every split of the SSD scan's forward and backward goes
through `split_bf16x2` in `csrc/hopper_sm90.cuh`, the one function the copy
edits (the backward's state and dy images then carry no lo plane).  `--make-variant NAME OUT` writes a copy with one of the
`VARIANTS`, another design of one kernel.  The card's name and
power limit come first; then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SPLIT = "void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {"
DROP_LO = ("\n    {   // control: plain bf16 operands, every lo term dropped\n"
           "        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);\n"
           "        hi = *reinterpret_cast<const uint32_t*>(&h);\n"
           "        lo = 0u;\n"
           "        return;\n"
           "    }")
# Alternatives to a kernel's design, each one edit of one source (file
# under csrc/, text, replacement):
# * sw32: a D 80 tile as five 16-column slabs, all 32-byte swizzled (five
#   TMA boxes a tile, one m64n80k16 product), in place of a 128-byte
#   swizzled 64-column slab and a 32-byte swizzled 16-column tail;
# * dkv-two-blocks: the dk/dv kernel at D 80 compiled for two blocks an SM
#   (ptxas then caps it at 168 registers, and it spills);
# * dq-head-pairs: the dq pass's items at rep 1 as at rep >= 2, one q tile
#   of a pair of heads, so at rep 1 the second warpgroup idles;
# * rms-one-vector, rms-two-vectors, rms-eight-vectors: the RMSNorm forward
#   at many rows with one, two or eight 16-byte vectors a thread (512, 256
#   or 64 threads a row at d 4096) in place of four;
# * rms-bwd-lane-major: the RMSNorm backward's four-vector instance (d 8200
#   to 16384) with each thread's dscale partial at 8 i + e of the shared
#   row (its own 32 bytes, an 8-way bank conflict a shared add) in place of
#   e * 2048 + i.
VARIANTS = {
    "sw32": ("hopper_sm90.cuh",
             "static constexpr int SW = D * 2 < 128 ? D * 2 : 128;",
             "static constexpr int SW = D == 80 ? 32 : D * 2 < 128 ? D * 2 : 128;"),
    "dkv-two-blocks": ("flash_attention_bwd.cu",
                       "__launch_bounds__(kDkvThreads, 1)\n    flash_bwd_dkv_kernel(",
                       "__launch_bounds__(kDkvThreads, D == 80 ? 2 : 1)\n"
                       "    flash_bwd_dkv_kernel("),
    "dq-head-pairs": ("flash_attention_bwd.cu",
                      "bool dq_tile_pairs(int rep) { return rep == 1; }",
                      "bool dq_tile_pairs(int rep) { return rep < 0; }"),
    "rms-one-vector": ("rmsnorm.cu", "constexpr int kFwdManyRowsVec = 4;",
                       "constexpr int kFwdManyRowsVec = 1;"),
    "rms-two-vectors": ("rmsnorm.cu", "constexpr int kFwdManyRowsVec = 4;",
                        "constexpr int kFwdManyRowsVec = 2;"),
    "rms-eight-vectors": ("rmsnorm.cu", "constexpr int kFwdManyRowsVec = 4;",
                          "constexpr int kFwdManyRowsVec = 8;"),
    "rms-bwd-lane-major": ("rmsnorm.cu", "{ return e * kBwdStride + i; }",
                           "{ return 8 * i + e; }"),
}
GROUPS = ("flash128", "head_dim_80", "rmsnorm", "decode", "ssd", "ssd_bwd")


def copy_with_edit(src: str, out: str, source: str, text: str, replacement: str) -> None:
    """A copy of the tree `src` at `out` with `text` in csrc/`source`
    replaced by `replacement` (it must occur exactly once)."""
    shutil.copytree(src, out, ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(out, "repro_torch", "kernels", "csrc", source)
    body = open(path).read()
    if body.count(text) != 1:
        raise SystemExit(f"kernel_ab: {path} has no single {text!r} to edit")
    open(path, "w").write(body.replace(text, replacement))


def make_control(src: str, out: str) -> None:
    copy_with_edit(src, out, "hopper_sm90.cuh", SPLIT, SPLIT + DROP_LO)


def ssm_cross_check(dev) -> dict:
    from repro_torch.launch.serve import Server
    from repro_torch.models import init_cache
    from repro_torch.runtime.steps import prefill_step, serve_step

    srv = Server(cs.SSM_ARCH, reduced=False, max_len=cs.SSM_PROMPT + 1, device="cuda",
                 seed=cs.SEED)
    cfg = srv.cfg
    prompts = np.random.default_rng(cs.SEED + 5).integers(
        1, cfg.vocab_size, size=(cs.BATCH, cs.SSM_PROMPT + 1)).astype(np.int32)
    with torch.inference_mode():
        toks = torch.from_numpy(prompts).long().to(dev)
        full, _ = prefill_step(srv.params, init_cache(cfg, cs.BATCH, 0, dev),
                               {"tokens": toks}, cfg)
        cache = init_cache(cfg, cs.BATCH, 0, dev)
        _, cache = prefill_step(srv.params, cache, {"tokens": toks[:, :cs.SSM_PROMPT]}, cfg)
        step, _ = serve_step(srv.params, cache, {"tokens": toks[:, cs.SSM_PROMPT:]},
                             cs.SSM_PROMPT, cfg)
        torch.cuda.synchronize()
    err, scale = float((step - full).abs().max()), float(full.abs().max())
    return {"cross_check_ssm": {"max_abs_err": err, "logit_absmax": scale,
                                "rel_err": err / scale, "tol": cs.TOL_CROSS,
                                "finite": bool(torch.isfinite(full).all()
                                               and torch.isfinite(step).all())}}


def ssd_bwd_split(fn, calls: int = 5) -> dict:
    """The device time of each CUDA kernel that `fn` (one SSD backward call)
    launches, in ms a call, from `torch.profiler` over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "ssd_bwd" in ev.key:
            name = ev.key.split("ssd_bwd", 1)[1].split("<")[0].split("(")[0]
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            out["ssd_bwd" + name] = us / 1e3 / calls
    return out


def timings(dev, groups=GROUPS) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import (decode_attention, flash_attention_bwd,
                                     flash_attention_bwd_dkv, flash_attention_bwd_dq,
                                     flash_attention_fwd, rmsnorm, rmsnorm_bwd, rmsnorm_ref,
                                     ssd_scan, ssd_scan_ref)
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.flash_attention import (attention_bwd_dkv_ref,
                                                     attention_bwd_dq_ref,
                                                     attention_with_lse_ref)

    rng = np.random.default_rng(cs.SEED)
    randn = cs.bf16_normal(rng, dev)
    scratch = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.sum()

    res = {}
    if "flash128" in groups:
        for name, hkv in (("", 2), ("_mha", 32)):
            q, k, v, do = cs.flash_bwd_inputs(randn, cs.TRAIN_B, cs.TRAIN_S, 32, hkv, 128)
            out, lse = flash_attention_fwd(q, k, v)
            res[f"dq{name}_ms"] = cs.time_ms(
                lambda: flash_attention_bwd_dq(q, k, v, out, do, lse), flush)
            if not name:
                res["dq_dkv_ms"] = cs.time_ms(
                    lambda: flash_attention_bwd(q, k, v, out, lse, do), flush)
                res["sdpa_bwd_ms"] = cs.time_ms(cs.sdpa_backward(q, k, v, do), flush)
            del q, k, v, do, out, lse

    # stablelm-3b's head dim 80 (MHA, 32 heads): the forward at the serve
    # prefill (k, v views of the 1024-row cache, kv_len 512) and train
    # shapes, and the dq, dk/dv and whole backward passes at the train shape,
    # whichever way the tree's wrappers take D 80 (padded or native)
    if "head_dim_80" in groups:
        xrandn = cs.bf16_normal(np.random.default_rng(cs.SEED + 7), dev)
        s, h = cs.TRAIN_S, 32
        for what, bb, t80 in (("serve", cs.BATCH, cs.MAX_LEN), ("train", cs.TRAIN_B, s)):
            q8 = xrandn(bb, s, h, 80).transpose(1, 2)
            k8, v8 = (xrandn(bb, t80, h, 80).transpose(1, 2) for _ in range(2))
            res[f"fwd80_{what}_ms"] = cs.time_ms(
                lambda q8=q8, k8=k8, v8=v8: flash_attention_fwd(q8, k8, v8, kv_len=s), flush)
        q8, k8, v8, do8 = cs.flash_bwd_inputs(xrandn, cs.TRAIN_B, s, h, h, 80)
        out8, lse8 = flash_attention_fwd(q8, k8, v8)
        dq8, delta8 = flash_attention_bwd_dq(q8, k8, v8, out8, do8, lse8)
        res["dq80_ms"] = cs.time_ms(
            lambda: flash_attention_bwd_dq(q8, k8, v8, out8, do8, lse8), flush)
        res["dkv80_ms"] = cs.time_ms(
            lambda: flash_attention_bwd_dkv(q8, k8, v8, do8, lse8, delta8), flush)
        res["bwd80_ms"] = cs.time_ms(
            lambda: flash_attention_bwd(q8, k8, v8, out8, lse8, do8), flush)
        # each pass at the train shape against its plain version (> 0: out of
        # chip_smoke.py's tolerance), so a variant is timed only where it is
        # right
        ref8, rlse8 = attention_with_lse_ref(q8, k8, v8, q_offset=0)
        rq8, rdelta8 = attention_bwd_dq_ref(q8, k8, v8, out8, do8, lse8, q_offset=0)
        dk8, dv8 = flash_attention_bwd_dkv(q8, k8, v8, do8, lse8, delta8)
        rk8, rv8 = attention_bwd_dkv_ref(q8, k8, v8, do8, lse8, delta8, q_offset=0)
        res["head_dim_80_excess_at_tol"] = {
            "fwd": max(cs.excess(out8, ref8, cs.TOL_BF16), cs.excess(lse8, rlse8, cs.TOL_LSE)),
            "dq": max(cs.excess(dq8, rq8, cs.TOL_BF16),
                      cs.excess(delta8, rdelta8, cs.TOL_LSE)),
            "dkv": max(cs.excess(dk8, rk8, cs.TOL_BF16), cs.excess(dv8, rv8, cs.TOL_BF16))}
        del q8, k8, v8, do8, out8, lse8, dq8, delta8, ref8, rlse8, rq8, rdelta8
        del dk8, dv8, rk8, rv8

    if "rmsnorm" in groups:
        nrng = cs.bf16_normal(np.random.default_rng(cs.SEED + 11), dev)
        for rows, d in ((cs.BATCH * cs.PROMPT, 4096), (cs.TRAIN_B * cs.TRAIN_S, 4096),
                        (cs.BATCH, 4096), (cs.BATCH, 768)):
            x, sc = nrng(rows, d, scale=3.0), 1.0 + 0.1 * nrng(d)
            res[f"rmsnorm_{rows}x{d}"] = {
                "ms": cs.time_ms(lambda x=x, sc=sc: rmsnorm(x, sc), flush),
                "excess_at_tol": cs.excess(rmsnorm(x, sc), rmsnorm_ref(x, sc),
                                           cs.TOL_RMSNORM)}
        x, dy = randn(cs.TRAIN_B * cs.TRAIN_S, 4096, scale=3.0), randn(cs.TRAIN_B * cs.TRAIN_S,
                                                                       4096)
        sc = 1.0 + 0.1 * randn(4096)
        res["rmsnorm_bwd_ms"] = cs.time_ms(lambda: rmsnorm_bwd(x, sc, dy), flush)
        del x, dy
        # jamba-1.5-large-398b's gated out_norm at [4096, 16384], where the
        # tree's wrapper takes d 16384: checked against its plain version as
        # chip_smoke.py's row, then timed
        from repro_torch.kernels.rmsnorm import kernel as rms_kernel
        if getattr(rms_kernel, "MAX_BWD_D", 0) >= 16384:
            wrng = cs.bf16_normal(np.random.default_rng(cs.SEED + 61), dev)
            x, sc = wrng(cs.TRAIN_B * cs.TRAIN_S, 16384, scale=3.0), 1.0 + 0.1 * wrng(16384)
            dy = wrng(cs.TRAIN_B * cs.TRAIN_S, 16384)
            res["rmsnorm_bwd_d16384"] = {
                **cs.rmsnorm_bwd_check(x, sc, dy),
                "ms": cs.time_ms(lambda: rmsnorm_bwd(x, sc, dy), flush)}
            del x, dy

    if "decode" in groups:
        lens = torch.from_numpy(np.random.default_rng(cs.SEED + 10).integers(
            cs.SERVE_LENGTHS[0], cs.SERVE_LENGTHS[1] + 1, size=cs.BATCH).astype(np.int32)).to(dev)
        for name, d, hkv in (("chatglm3_6b", 128, 2), ("stablelm_3b", 80, 32)):
            if d not in decode_kernel.HEAD_DIMS:        # an earlier tree
                res[f"decode_{name}_ms"] = None
                continue
            qd = randn(cs.BATCH, 32, d)
            kd, vd = (randn(cs.BATCH, cs.MAX_LEN, hkv, d) for _ in range(2))
            res[f"decode_{name}_ms"] = cs.time_ms(lambda: decode_attention(qd, kd, vd, lens),
                                                  flush)
            if hasattr(decode_kernel, "CLUSTERS"):      # every cluster size the tree takes
                res[f"decode_{name}_cluster_ms"] = {
                    str(c): cs.time_ms(lambda c=c: decode_attention(qd, kd, vd, lens, cluster=c),
                                       flush) for c in decode_kernel.CLUSTERS}
            del qd, kd, vd
        res["decode_lengths"] = lens.tolist()

    if "ssd" in groups:
        scfg = get_config(cs.SSM_ARCH)
        ps, ns = scfg.ssm.head_dim, scfg.ssm.d_state
        hs = scfg.ssm.expand * scfg.d_model // ps
        with torch.inference_mode():
            for name, sl, sc0 in (("serve", cs.SSM_PROMPT, 0.0), ("tail", cs.SSM_PROMPT + 1, 0.3)):
                sargs, h0 = cs.ssd_inputs(randn, rng, dev, cs.BATCH, sl, hs, ps, ns, sc0)
                (y, hf), (ry, rh) = (ssd_scan(*sargs, h0=h0),
                                     ssd_scan_ref(*sargs, chunk=scfg.ssm.chunk, h0=h0))
                rel = cs.ssd_rel_errors(sargs, h0, {"kernel": (y, hf), "plain": (ry, rh)})
                res[f"ssd_{name}"] = {
                    "y_max_abs_err": float((y - ry).abs().max()),
                    "h_final_max_abs_err": float((hf - rh).abs().max()),
                    "rel_l2_vs_fp64": rel,
                    "over_tol_rel_l2": max(rel["kernel"].values()) > cs.TOL_SSD_REL_L2}
                if name == "serve":
                    res["ssd_ms"] = cs.time_ms(lambda: ssd_scan(*sargs, h0=h0), flush)
                del sargs, h0, y, hf, ry, rh

    if "ssd_bwd" in groups:
        from repro_torch import kernels
        if hasattr(kernels, "ssd_scan_bwd"):
            scfg = get_config(cs.SSM_ARCH)
            ps, ns = scfg.ssm.head_dim, scfg.ssm.d_state
            hs = scfg.ssm.expand * scfg.d_model // ps
            brng = np.random.default_rng(cs.SEED + 13)
            bargs, _ = cs.ssd_inputs(cs.bf16_normal(brng, dev), brng, dev, cs.TRAIN_B,
                                     cs.SSM_TRAIN_S, hs, ps, ns, 0.0)
            bdy = torch.from_numpy(brng.standard_normal((cs.TRAIN_B, cs.SSM_TRAIN_S, hs, ps),
                                                        dtype=np.float32)).to(dev)
            got = kernels.ssd_scan_bwd(*bargs, None, bdy, None)
            want = kernels.ssd_scan_bwd_ref(*bargs, None, bdy, None, chunk=cs.SSD_CHUNK)
            exact = cs.ssd_grads_f64(kernels.ssd_scan_ref, bargs, None, bdy, None,
                                     chunk=scfg.ssm.chunk)
            names = ("dx", "ddt", "da_log", "dB", "dC")
            res["ssd_bwd"] = {
                "ms": cs.time_ms(lambda: kernels.ssd_scan_bwd(*bargs, None, bdy, None), flush),
                "excess_at_tol": max(cs.excess(g, w, cs.TOL_BF16)
                                     for g, w in zip(got, want) if g is not None),
                "rel_l2_vs_fp64": {nm: cs.rel_l2(g, e.to(g.dtype))
                                   for nm, g, e in zip(names, got, exact)},
                "kernel_ms_per_call": ssd_bwd_split(
                    lambda: kernels.ssd_scan_bwd(*bargs, None, bdy, None))}
            del bargs, bdy, got, want, exact
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--ssm-cross-check", action="store_true")
    ap.add_argument("--make-control", metavar="OUT")
    ap.add_argument("--make-variant", nargs=2, metavar=("NAME", "OUT"))
    ap.add_argument("--groups", nargs="+", choices=GROUPS, default=list(GROUPS),
                    help="what to time (default: all)")
    args = ap.parse_args()
    if args.make_control:
        make_control(args.src, args.make_control)
        return 0
    if args.make_variant:
        name, out = args.make_variant
        if name not in VARIANTS:
            raise SystemExit(f"kernel_ab: variants are {sorted(VARIANTS)}")
        copy_with_edit(args.src, out, *VARIANTS[name])
        return 0
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    res = {"src": os.path.abspath(args.src)}
    res.update(ssm_cross_check(dev) if args.ssm_cross_check
               else timings(dev, groups=args.groups))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

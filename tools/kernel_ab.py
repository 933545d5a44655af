#!/usr/bin/env python3
"""Time the flash dq pass and the SSD scan of one source tree on one NVIDIA card.

    python3 tools/kernel_ab.py [--src DIR]

Imports `repro_torch` from DIR (default: this checkout's `src`), so that two
trees, such as a parent commit unpacked into a git-ignored directory and
this one, can be timed in turns in one call: each builds its own kernels
into its own `build/`.  The inputs, timer and accuracy measures are
`chip_smoke.py`'s, at its shapes: the chatglm3-6b train step's attention
(B 8, H 32, Hkv 2, S 512, D 128, causal), where it times the dq pass, the
whole flash backward (dq, then dk/dv) and SDPA's backward; and the
mamba2-130m prefill (4 x 8192 tokens, x/B/C strided as the model passes
them, zero state), where it times the SSD scan.  For the scan it prints
the largest error of y and of the final state against the plain version,
and the relative L2 error of the kernel and of the plain version against
the fp64 recurrence, with whether the kernel's exceeds
`chip_smoke.TOL_SSD_REL_L2`, there and at S = 8193 from an N(0, 0.3^2)
state.  The card's name and power limit come first; then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import (flash_attention_bwd, flash_attention_bwd_dq,
                                     flash_attention_fwd, ssd_scan, ssd_scan_ref)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    randn = cs.bf16_normal(rng, dev)
    scratch = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.sum()

    res = {"src": os.path.abspath(args.src)}
    q, k, v, do = cs.flash_bwd_inputs(randn, cs.TRAIN_B, cs.TRAIN_S, 32, 2, 128)
    out, lse = flash_attention_fwd(q, k, v)
    res["dq_ms"] = cs.time_ms(lambda: flash_attention_bwd_dq(q, k, v, out, do, lse), flush)
    res["dq_dkv_ms"] = cs.time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do), flush)
    res["sdpa_bwd_ms"] = cs.time_ms(cs.sdpa_backward(q, k, v, do), flush)
    del q, k, v, do, out, lse

    scfg = get_config(cs.SSM_ARCH)
    ps, ns = scfg.ssm.head_dim, scfg.ssm.d_state
    hs = scfg.ssm.expand * scfg.d_model // ps
    with torch.inference_mode():
        for name, sl, sc in (("serve", cs.SSM_PROMPT, 0.0), ("tail", cs.SSM_PROMPT + 1, 0.3)):
            sargs, h0 = cs.ssd_inputs(randn, rng, dev, cs.BATCH, sl, hs, ps, ns, sc)
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
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

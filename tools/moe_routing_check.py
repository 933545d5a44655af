#!/usr/bin/env python3
"""Where two runs of the MoE serve path part: routing flips at near-ties.

    python3 tools/moe_routing_check.py [--src DIR] [--skip-full]
        [--train-seeds S ...]

Every `moe_route` call of a run is recorded (`chip_smoke.RouteRecorder`:
its top_idx and, per token, the gap between the k-th and (k+1)-th largest
selection scores), so that two runs that should agree can be compared
route by route.  A token whose experts differ is printed with its gap on
each side: a flip at a gap of the size of the runs' rounding noise is
rounding, not a fault.  One JSON line per comparison:

1. card vs CPU, reduced deepseek-v2-lite-16b and deepseek-v3-671b
   (`tests/test_torch_cuda.py`'s reduced deepseek test: Server seed 3,
   tokens seed 4, a 40-token prefill and 8 decode steps): per step, the
   logits' relative L2 error and max |diff|, and the routes that differ.
2. full-width deepseek-v2-lite-16b, `chip_smoke.py`'s cross_check_moe
   (`chip_smoke.moe_cross_check`: the same weights, prompts and
   capacity_factor), with every flip listed.
3. with `--train-seeds`, `chip_smoke.py`'s train_check_moe at each seed
   (`chip_smoke.train_check` on reduced deepseek-v2-lite-16b with MLA at
   the full head dims, 2 x 192 tokens; the card test's seeds are 40 and
   41, chip_smoke's 18): the pinned run's flips, and an unpinned CPU
   forward's, each flip at a gap >= NEAR_TIE with the flips upstream of it.
   Only these run when seeds are given.
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


def _rel(a, b) -> dict:
    a, b = a.float().cpu(), b.float().cpu()
    return {"rel_l2": float((a - b).norm() / b.norm()), "max_abs": float((a - b).abs().max()),
            "absmax": float(b.abs().max())}


def card_vs_cpu(arch, rec, dev) -> dict:
    from repro_torch.launch.serve import Server
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.tree import tree_map

    gpu = Server(arch, max_len=64, device=dev, seed=3)
    cpu_params = tree_map(lambda t: t.cpu(), gpu.params)
    cfg = gpu.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)))
    steps = []
    with torch.inference_mode():
        cg, cc = init_cache(cfg, 2, 64, dev), init_cache(cfg, 2, 64, "cpu")
        for i in [None, *range(40, 48)]:
            if i is None:
                lg, cg = prefill(gpu.params, {"tokens": toks[:, :40].to(dev)}, cfg, cg)
                rg = rec.take()
                lc, cc = prefill(cpu_params, {"tokens": toks[:, :40]}, cfg, cc)
            else:
                step = toks[:, i:i + 1]
                lg, cg = decode_step(gpu.params, {"tokens": step.to(dev)}, cfg, cg, i)
                rg = rec.take()
                lc, cc = decode_step(cpu_params, {"tokens": step}, cfg, cc, i)
            steps.append({"step": "prefill" if i is None else f"decode {i}", **_rel(lg, lc),
                          "route_flips": cs.route_flips(rg, rec.take())})
    return {"check": "card_vs_cpu", "arch": arch, "reduced": True,
            "gap": "k-th minus (k+1)-th selection score; a: card, b: CPU", "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--skip-full", action="store_true",
                    help="only the reduced card-vs-CPU comparisons")
    ap.add_argument("--train-seeds", type=int, nargs="+", default=[],
                    help="run train_check_moe at these seeds instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_routing_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.launch.serve import Server
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.train_seeds:
        cfg = cs.moe_small_config()
        seq = 3 * cs.FLASH_TILE
        for seed in args.train_seeds:
            print(json.dumps({"check": "train_check_moe", "seed": seed,
                              **cs.train_check(dev, cfg, seed, seq, seq - 40)}), flush=True)
        return 0
    with cs.RouteRecorder(layers) as rec:
        for arch in ("deepseek-v2-lite-16b", "deepseek-v3-671b"):
            print(json.dumps(card_vs_cpu(arch, rec, dev)), flush=True)
    if not args.skip_full:
        srv = Server(cs.MOE_ARCH, reduced=False, max_len=cs.MAX_LEN, device=dev, seed=cs.SEED)
        prompts = np.random.default_rng(cs.SEED + 11).integers(
            1, srv.cfg.vocab_size, size=(cs.BATCH, cs.PROMPT + 1)).astype(np.int32)
        print(json.dumps({"check": "cross_check_moe",
                          **cs.moe_cross_check(srv, prompts, dev, cs.MAX_LEN)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the port's serve path goes, on one NVIDIA card.

    python3 tools/serve_profile.py [--arch mamba2-130m | stablelm-3b |
                                    deepseek-v2-lite-16b | deepseek-v3-671b |
                                    jamba-1.5-large-398b | command-r-35b |
                                    starcoder2-15b | pixtral-12b |
                                    musicgen-large] [--src DIR]

Builds a full-width model (chatglm3-6b by default, or any arch above;
deepseek-v3-671b and jamba-1.5-large-398b cut as `chip_smoke.py`'s
serve_v3 and serve_hybrid cut them, read from its `V3_SERVE_LAYERS` and
`hybrid_serve_config`; random weights from seed 0; pixtral-12b and
musicgen-large fed their stub frontend's embeds, as `Server` feeds them),
prefills 4 prompts
(512 tokens, 8192 for mamba2-130m, as `chip_smoke.py` serves them) and
decodes 8 tokens, each phase under `torch.profiler`.  For each phase it
prints one JSON line: the wall time (host clock, synchronised), the device
busy time (sum of kernel durations, one stream), the device idle share, the
kernels that take the most device time, and the copy kernels' launches and
device time (any kernel whose name holds "copy").  For the moe family the
line also splits the device time of the MoE layers (`apply_moe`): the
expert products (its batched matmuls), their silu, the router, the slot
numbering, the shared experts, and the rest: the dispatch gather, the
combine, the aux loss and the casts and gate product around the silu; and
gives MLA's (`mla_fwd`).  For the hybrid family the line splits the device
time by layer kind instead (`hybrid_split_ms`): the Mamba layers (`ssm_fwd`,
and within them the SSD scan's kernel and the gated out_norm's RMSNorm),
the attention layer (`attention_fwd`), the MoE FFNs (`apply_moe`), the
dense FFNs (`apply_mlp`), and the rest (the embedding, the layer norms
outside those, the head).  For a dense model (`dense_split_ms`): attention
(`attention_fwd`: projections, rope, the flash or decode kernel, the cache
writes), the MLP (`apply_mlp`), the norms (`apply_norm`: the RMSNorm
kernel, or LayerNorm's plain torch ops), and the rest (the embedding and
positions, the head, the argmax).  Each of those functions runs inside
a `record_function` range for the profile; the device time of a range
sums the kernels of every op it called.  `--src DIR` profiles the
`repro_torch` under DIR (default: this checkout's `src`).  The card's name
and power limit are printed first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


# the functions of `models/layers.py` (and `models/ssm.py`'s ssm_fwd) each run
# inside a range of their name
SCOPES = ("apply_moe", "moe_route", "moe_slots", "apply_mlp", "mla_fwd")
HYBRID_SCOPES = ("ssm_fwd", "attention_fwd", "apply_moe", "apply_mlp")
DENSE_SCOPES = ("attention_fwd", "apply_mlp", "apply_norm")
RANGES = set(SCOPES + HYBRID_SCOPES + DENSE_SCOPES)


def _scope(mod, names) -> None:
    """Wrap each `mod.<name>` in a `record_function` range of that name."""
    for n in names:
        def wrapped(*a, _fn=getattr(mod, n), _n=n, **k):
            with torch.profiler.record_function(_n):
                return _fn(*a, **k)
        setattr(mod, n, wrapped)


def _device_ms(ev) -> float:
    """Device ms of the kernels an op launched, its children's included.  A
    range's own span on the device, which the profiler lists beside the
    kernels under the range's name, is left out."""
    return (sum(k.duration for k in ev.kernels if k.name not in RANGES)
            / 1e3 + sum(_device_ms(ch) for ch in ev.cpu_children))


def _moe_split(prof) -> dict:
    """Device ms of the MoE layers and their parts, and of MLA attention."""
    parts = ("expert_products", "expert_silu", "router", "slots", "shared_experts")
    ms = dict.fromkeys(("moe", *parts, "dispatch_combine_and_rest", "mla"), 0.0)
    part = {"aten::bmm": "expert_products", "aten::silu": "expert_silu",
            "moe_route": "router", "moe_slots": "slots", "apply_mlp": "shared_experts"}
    for ev in prof.events():
        if ev.name == "mla_fwd":
            ms["mla"] += _device_ms(ev)
        if ev.name != "apply_moe":
            continue
        ms["moe"] += _device_ms(ev)
        for ch in ev.cpu_children:
            if ch.name in part:
                ms[part[ch.name]] += _device_ms(ch)
    ms["dispatch_combine_and_rest"] = ms["moe"] - sum(ms[k] for k in parts)
    return ms


def _kernel_ms(ev, name) -> float:
    """Device ms of the kernels whose name holds `name` that an op launched,
    its children's included."""
    return (sum(k.duration for k in ev.kernels if name in k.name) / 1e3
            + sum(_kernel_ms(ch, name) for ch in ev.cpu_children))


def _scope_split(prof, busy_ms, scopes) -> dict:
    """Device ms of each range in `scopes`, and of the rest."""
    ms = dict.fromkeys(scopes, 0.0)
    for ev in prof.events():
        if ev.name in ms:
            ms[ev.name] += _device_ms(ev)
    out = {f"{k}_ms": v for k, v in ms.items()}
    out["rest_ms"] = busy_ms - sum(ms.values())
    return out


def _hybrid_split(prof, busy_ms) -> dict:
    """Device ms of a hybrid model's layer kinds, and within the Mamba layers
    the SSD scan's and the RMSNorm's kernels (their other ops: in_proj and
    out_proj, the conv, the gate; a decode step's recurrence)."""
    out = _scope_split(prof, busy_ms, HYBRID_SCOPES)
    for k in ("ssd_scan_kernel", "rmsnorm_kernel"):
        out[f"ssm_fwd.{k}_ms"] = sum(_kernel_ms(ev, k) for ev in prof.events()
                                     if ev.name == "ssm_fwd")
    return out


def _phase(name, fn, n_items, moe=False, hybrid=False, dense=False):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    copies = [e for e in kernels if "copy" in e.key.lower()]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    split = ({"hybrid_split_ms": _hybrid_split(prof, busy_ms)} if hybrid
             else {"moe_split_ms": _moe_split(prof)} if moe
             else {"dense_split_ms": _scope_split(prof, busy_ms, DENSE_SCOPES)} if dense
             else {})
    print(json.dumps({
        "phase": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "per_item_wall_ms": wall_ms / n_items,
        "copies": {"ms": sum(e.self_device_time_total for e in copies) / 1e3,
                   "count": sum(e.count for e in copies)},
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                         "count": e.count} for e in top], **split}), flush=True)


PROMPT = {"chatglm3-6b": 512, "mamba2-130m": 8192, "stablelm-3b": 512,
          "deepseek-v2-lite-16b": 512, "deepseek-v3-671b": 512,
          "jamba-1.5-large-398b": 512, "command-r-35b": 512, "starcoder2-15b": 512,
          "pixtral-12b": 512, "musicgen-large": 512}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=sorted(PROMPT))
    ap.add_argument("--src", default=SRC)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_table
    from repro_torch.models import init_cache, init_model
    from repro_torch.models import layers, ssm
    from repro_torch.runtime.steps import prefill_step, serve_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import HYBRID_ARCH, V3_ARCH, V3_SERVE_LAYERS, hybrid_serve_config
    if args.arch == V3_ARCH:                                    # serve_v3's depth cut
        cfg = replace(cfg, n_layers=V3_SERVE_LAYERS)
    if args.arch == HYBRID_ARCH:                                # serve_hybrid's cut
        cfg = hybrid_serve_config()
    hybrid = cfg.family == "hybrid"
    moe = cfg.moe is not None and not hybrid
    dense = cfg.family != "ssm" and not (hybrid or moe)
    if moe:
        _scope(layers, SCOPES)
    if hybrid:
        _scope(layers, HYBRID_SCOPES[1:])
        _scope(ssm, HYBRID_SCOPES[:1])
    if dense:
        _scope(layers, DENSE_SCOPES)
    b, s0, steps, seed = 4, PROMPT[args.arch], 8, 0
    max_len = 2 * s0
    with torch.inference_mode():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            1, cfg.vocab_size, size=(b, s0))).to(dev)
        # a stub frontend's embeds: each token's row of its table, as Server
        stub = (None if cfg.frontend is None
                else stub_table(cfg.vocab_size, cfg.d_model, dev))

        def batch(t):
            return {"tokens": t} if stub is None else {"tokens": t, "embeds": stub[t]}

        cache = init_cache(cfg, b, max_len, dev)
        prefill_step(params, cache, batch(toks), cfg)      # warm-up
        cache = init_cache(cfg, b, max_len, dev)    # an ssm prefill starts from the cache's state
        state = {}

        def run_prefill():
            state["logits"], state["cache"] = prefill_step(params, cache, batch(toks), cfg)

        def run_decode():
            tok = state["logits"][:, -1].argmax(-1)
            for i in range(steps):
                lg, _ = serve_step(params, state["cache"], batch(tok[:, None]), s0 + i, cfg)
                tok = lg[:, -1].argmax(-1)

        print(json.dumps({"arch": args.arch, "n_layers": cfg.n_layers, "batch": b, "prompt": s0,
                          "src": os.path.abspath(args.src)}), flush=True)
        _phase("prefill", run_prefill, 1, moe, hybrid, dense)
        _phase("decode", run_decode, steps, moe, hybrid, dense)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA card.

    python3 tools/train_profile.py [--arch stablelm-3b | mamba2-130m |
        deepseek-v2-lite-16b | deepseek-v3-671b] [--src DIR]

Builds full-width chatglm3-6b (random weights from seed 0, AdamW with bf16
moments, as `chip_smoke.py` trains it), stablelm-3b, mamba2-130m,
deepseek-v2-lite-16b or deepseek-v3-671b (fp32 moments; the deepseek
models cut to the depth of `chip_smoke.py`'s train_moe and train_v3, read
from its `MOE_TRAIN_LAYERS` and `V3_TRAIN_LAYERS`) and runs
two train steps as warm-up and one for the wall time of a whole step, at
`chip_smoke.py`'s train shapes (8 x 512 tokens; mamba2-130m 8 x 2048).
Then it profiles the step's two halves under `torch.profiler`: the forward
and backward (`loss_fn` and `torch.autograd.grad`), and the AdamW update.
For each it prints one JSON line: the wall time (host clock,
synchronised), the device busy time (sum of kernel durations, one stream),
the device idle share, the kernel launches, the device time by group (the
ported kernels, cuBLAS GEMMs, the rest), the device time of each ported
kernel, and the kernels that take the most device time, and the copy
kernels' launches and device time (any kernel whose name holds "copy":
layout changes, padding, slices made contiguous).  For the moe family the
forward and backward line also splits the device time by
`models/layers.py` function: MLA (`mla_fwd`), the MoE layers (`apply_moe`)
and their expert products (batched matmuls), router, slot numbering,
shared experts and the rest (dispatch gather, combine, aux loss), each run
inside a `record_function` range (the forward and the remat recompute);
and the backward's device time by autograd node (`backward_nodes_ms`: each
node's kernels, without the MLA and MoE ranges of the remat recompute it
triggers).  `--src DIR` profiles the `repro_torch` under DIR (default:
this checkout's `src`), so two trees can be profiled in one call.  The
card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MOMENTS = {"chatglm3-6b": torch.bfloat16, "stablelm-3b": torch.float32,
           "mamba2-130m": torch.float32, "deepseek-v2-lite-16b": torch.float32,
           "deepseek-v3-671b": torch.float32}
SEQ = {"chatglm3-6b": 512, "stablelm-3b": 512, "mamba2-130m": 2048,
       "deepseek-v2-lite-16b": 512, "deepseek-v3-671b": 512}
# the functions of `models/layers.py` each run inside a range of their name
SCOPES = ("apply_moe", "moe_route", "moe_slots", "apply_mlp", "mla_fwd")
NODE = "autograd::engine::evaluate_function: "
PORTED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rmsnorm_kernel",
          "rmsnorm_bwd", "ce_fwd", "ce_bwd", "ssd_scan_kernel", "ssd_bwd")
GEMM = ("nvjet", "gemm", "cutlass", "xmma")


def _group(name: str) -> str:
    if any(k in name for k in PORTED):
        return "ported kernels"
    if any(k in name.lower() for k in GEMM):
        return "GEMM"
    return "other"


def _scope(mod, names) -> None:
    """Wrap each `mod.<name>` in a `record_function` range of that name."""
    for n in names:
        def wrapped(*a, _fn=getattr(mod, n), _n=n, **k):
            with torch.profiler.record_function(_n):
                return _fn(*a, **k)
        setattr(mod, n, wrapped)


def _device_ms(ev, skip=()) -> float:
    """Device ms of the kernels an op launched, its children's included but
    for children named in `skip`; a range's own span on the device, listed
    under the range's name, is left out."""
    return (sum(k.duration for k in ev.kernels if k.name not in SCOPES) / 1e3
            + sum(_device_ms(ch, skip) for ch in ev.cpu_children if ch.name not in skip))


def _moe_split(prof) -> dict:
    """Device ms of MLA, of the MoE layers and their parts (forward and
    remat recompute), and of the backward by autograd node."""
    parts = ("expert_products", "expert_silu", "router", "slots", "shared_experts")
    ms = dict.fromkeys(("moe", *parts, "dispatch_combine_and_rest", "mla"), 0.0)
    part = {"aten::bmm": "expert_products", "aten::silu": "expert_silu",
            "moe_route": "router", "moe_slots": "slots", "apply_mlp": "shared_experts"}
    nodes: dict = {}
    for ev in prof.events():
        if ev.name.startswith(NODE):
            key = ev.name[len(NODE):]
            nodes[key] = nodes.get(key, 0.0) + _device_ms(ev, skip=SCOPES)
        if ev.name == "mla_fwd":
            ms["mla"] += _device_ms(ev)
        if ev.name != "apply_moe":
            continue
        ms["moe"] += _device_ms(ev)
        for ch in ev.cpu_children:
            if ch.name in part:
                ms[part[ch.name]] += _device_ms(ch)
    ms["dispatch_combine_and_rest"] = ms["moe"] - sum(ms[k] for k in parts)
    top = dict(sorted(nodes.items(), key=lambda kv: -kv[1])[:16])
    return {"forward_and_recompute_ms": ms, "backward_nodes_ms": top,
            "backward_nodes_total_ms": sum(nodes.values())}


def _phase(name, fn, moe=False, **extra):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the record_function ranges' own spans on the device are not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in SCOPES]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(_group(e.key), {"ms": 0.0, "count": 0})
        g["ms"] += e.self_device_time_total / 1e3
        g["count"] += e.count
    ported: dict = {}
    for e in kernels:
        key = next((k for k in PORTED if k in e.key), None)
        if key is not None:
            g = ported.setdefault(key, {"ms": 0.0, "count": 0})
            g["ms"] += e.self_device_time_total / 1e3
            g["count"] += e.count
    copies = [e for e in kernels if "copy" in e.key.lower()]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    split = {"moe_split": _moe_split(prof)} if moe else {}
    print(json.dumps({
        "phase": name, **extra, **split, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "kernel_launches": sum(e.count for e in kernels), "groups": groups,
        "ported_kernels": ported,
        "copies": {"ms": sum(e.self_device_time_total for e in copies) / 1e3,
                   "count": sum(e.count for e in copies)},
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                         "count": e.count} for e in top]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=sorted(MOMENTS))
    ap.add_argument("--src", default=SRC)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.models import layers, loss_fn
    from repro_torch.optim import adamw_update
    from repro_torch.runtime.steps import param_grads
    from repro_torch.tree import tree_leaves, tree_unflatten

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    b, s = 8, SEQ[args.arch]
    moe = get_config(args.arch).moe is not None
    n_layers = None
    if moe:
        sys.path.insert(0, ROOT)
        # train_moe's and train_v3's depth cuts
        from chip_smoke import MOE_TRAIN_LAYERS, V3_ARCH, V3_TRAIN_LAYERS
        n_layers = V3_TRAIN_LAYERS if args.arch == V3_ARCH else MOE_TRAIN_LAYERS
        _scope(layers, SCOPES)
    tc = TrainerConfig(arch=args.arch, reduced=False, global_batch=b, seq_len=s,
                       steps=1, device="cuda", seed=0, moment_dtype=MOMENTS[args.arch],
                       n_layers=n_layers)
    toks = np.random.default_rng(4).integers(1, get_config(args.arch).vocab_size,
                                             size=(b, s + 1)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((b, s), np.float32)}
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    tr.init_state()
    batch = tr._to_device(fixed)
    for _ in range(2):                                   # warm-up: cuBLAS, allocator
        tr.state, _ = tr.step_fn(tr.state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.state, metrics = tr.step_fn(tr.state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3

    params, held = tr.state["params"], {}

    def forward_backward():
        loss, _ = loss_fn(params, batch, tr.cfg)
        held["grads"] = param_grads(loss, tree_leaves(params))

    def update():
        adamw_update(tree_unflatten(params, list(held.pop("grads"))), tr.state["opt"],
                     params, tr.opt_cfg)

    _phase("forward_backward", forward_backward, moe=moe, arch=args.arch,
           n_layers=tr.cfg.n_layers, src=os.path.abspath(args.src),
           step_ms_unprofiled=step_ms,
           loss=float(metrics["loss"]), tokens=b * s)
    _phase("adamw_update", update, n_params=sum(t.numel() for t in tree_leaves(params)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

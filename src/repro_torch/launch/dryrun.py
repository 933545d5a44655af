"""Multi-pod dry run of the port: the counterpart of `repro/launch/dryrun.py`.

Every (architecture x input shape x mesh) cell is traced as rank 0 of a
fake process group of the mesh's size (`torch.distributed`'s "fake"
backend: no peer, no network), its state, params, cache and batch fake
tensors (`runtime.steps.abstract_*`; nothing is allocated), placed as JAX's
cell places them, and its step run once under the cell's activation specs
inside `analysis.trace.StepTrace`, which counts the rank's FLOPs, bytes,
collective bytes by kind and the peak of its live bytes: the per-device
numbers of a mesh no one card can form, traced, not run.  The kernels take
their abstract path (`kernels/abstract.py`) and each wrapper's fake calls
are `kernel_calls`.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

The cells to trace run in a pool of spawned processes, one a core (a
cell's trace is host Python and takes one core).

It needs no card: `--device cpu` traces CPU tensors on a cpu-typed mesh.
The default `cuda` gives the fake tensors the card's device and the mesh
its type, whose collectives (all-to-all) are those NCCL runs; it needs a
PyTorch built with CUDA.  Results are stored after each cell in
`build/dryrun_torch.json` under the checkout (or `--out`), so an
interrupted sweep resumes where it left off; the sweep exits 1 if a cell
failed, as JAX's does.  JAX's `--keep-hlo` has no counterpart (no HLO).

The record keeps JAX's keys where they mean the same: `flops_per_device`,
`bytes_accessed_per_device`, `collective_bytes_per_device` and `memory`
with `argument_bytes`, `output_bytes`, `temp_bytes` (the peak beyond the
arguments and the outputs not updated in place) and `alias_bytes` (the state
or cache updated in place, where JAX donates); `peak_bytes` beside them.
JAX's `lower_s` and `compile_s` are one `trace_s`.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..analysis.trace import StepTrace, local_bytes, shared_bytes
from ..configs import ARCH_IDS, get_config, shapes_for
from ..configs.base import InputShape, ModelConfig
from ..context import activation_specs
from ..kernels import reset_traced, traced_calls
from ..optim import AdamWConfig
from ..runtime import sharding as sh
from ..runtime.steps import (abstract_batch, abstract_cache, abstract_params, abstract_state,
                             prefill_step, serve_step, shard_batch, shard_cache, shard_params,
                             shard_train_state, train_step)
from .mesh import make_production_mesh

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch.json")
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}

# HBM-bound giants keep Adam moments in bf16 (see optim.adamw)
BF16_MOMENT_ARCHS = {"deepseek-v3-671b", "jamba-1.5-large-398b",
                     "command-r-35b"}


def opt_cfg_for(arch: str, moment_dtype: Optional[torch.dtype] = None) -> AdamWConfig:
    """JAX's choice of moment dtype for `arch`, unless `moment_dtype` is given."""
    if moment_dtype is None:
        moment_dtype = torch.bfloat16 if arch in BF16_MOMENT_ARCHS else torch.float32
    return AdamWConfig(moment_dtype=moment_dtype)


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A fake default process group of `n` ranks, this process rank 0;
    destroyed on exit.  Raises if a default group is already up (a real
    one must not be replaced under its users)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised: the dry run "
                           "traces on a fake group of its own; run it with none up")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(cfg: ModelConfig, shape: InputShape, mesh, mode: StepTrace, device,
               opt_cfg: AdamWConfig) -> Tuple[Any, Tuple]:
    """(step, args): the cell's step as a function of nothing and its
    arguments, fake tensors of `mode` placed as JAX's `build_cell` places
    them (the train state and params by `param_specs`, the cache by
    `cache_specs`, the batch by `batch_shardings`).  A decode step runs one
    token against a cache filled to seq_len - 1."""
    if shape.kind == "train":
        state = shard_train_state(abstract_state(cfg, opt_cfg, device, mode), cfg, mesh)
        batch = shard_batch(abstract_batch(cfg, shape, device=device, mode=mode), mesh, shape)
        return (lambda: train_step(state, batch, cfg, opt_cfg)), (state, batch)
    params = shard_params(abstract_params(cfg, device, mode), cfg, mesh)
    b, s = shape.global_batch, shape.seq_len
    cache = shard_cache(abstract_cache(cfg, b, s, device, mode), cfg, mesh, b, s)
    decode = shape.kind == "decode"
    batch = shard_batch(abstract_batch(cfg, shape, for_decode=decode, device=device, mode=mode),
                        mesh, shape, for_decode=decode)
    if decode:
        return (lambda: serve_step(params, cache, batch, s - 1, cfg)), (params, cache, batch)
    return (lambda: prefill_step(params, cache, batch, cfg)), (params, cache, batch)


def run_cell(arch: str, shape: InputShape, *, mesh_shape: Sequence[int] = (16, 16),
             device: str = "cuda", moment_dtype: Optional[torch.dtype] = None,
             reduced: bool = False) -> Dict[str, Any]:
    """Trace one cell as rank 0 of a fake group of the mesh's size (any
    shape of two or three dims: (16, 16) and (2, 16, 16) as JAX's, (1, 1)
    for one card) and return its record; `reduced` traces `cfg.reduced()`."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    mesh_shape = tuple(mesh_shape)
    n_dev = 1
    for m in mesh_shape:
        n_dev *= m
    opt_cfg = opt_cfg_for(arch, moment_dtype)
    t0 = time.time()
    with fake_world(n_dev):
        mesh = make_production_mesh(shape=mesh_shape, device_type=torch.device(device).type)
        mode = StepTrace()
        with mode:
            step, args = build_cell(cfg, shape, mesh, mode, device, opt_cfg)
            arg_bytes = local_bytes(args)
            reset_traced()
            with activation_specs(sh.activation_specs_for(sh.mesh_shape(mesh), shape, cfg)):
                with mode.counting():
                    out = step()
            calls = traced_calls()
            out_bytes, alias = local_bytes(out), shared_bytes(args, out)
        counts = mode.totals()
        del step, args, out
    peak = counts["peak_bytes"]
    return {
        "arch": arch, "reduced": reduced, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_name(mesh_shape),
        "devices": n_dev, "device": str(device), "moment_dtype":
            str(opt_cfg.moment_dtype).split(".")[-1] if shape.kind == "train" else None,
        "trace_s": round(time.time() - t0, 1),
        "flops_per_device": counts["flops"],
        "bytes_accessed_per_device": counts["bytes"],
        "collective_bytes_per_device": counts["collective_bytes"],
        "collective_calls": counts["collective_calls"],
        "kernel_flops_per_device": counts["kernel_flops"],
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(0, peak - arg_bytes - out_bytes + alias),
                   "alias_bytes": alias, "peak_bytes": peak},
        "kernel_calls": {k: v for k, v in calls.items() if v},
        "ok": True,
    }


# ---------------------------------------------------------------------------
# the sweep, with incremental JSON persistence
# ---------------------------------------------------------------------------

def load_results(path: str = RESULTS) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def store_result(key: str, rec: Dict[str, Any], path: str = RESULTS) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    res = load_results(path)
    res[key] = rec
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cell_key(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}|{shape}|{mesh}"


def cell_record(arch: str, shape_name: str, mesh: str, device: str) -> Dict[str, Any]:
    """`run_cell`'s record of one sweep cell, or the failed cell's record
    (its error and the end of its traceback), as JAX's sweep keeps it."""
    shp = next(s for s in shapes_for(get_config(arch)) if s.name == shape_name)
    try:
        return run_cell(arch, shp, mesh_shape=MESHES[mesh], device=device)
    except Exception as e:  # noqa: BLE001
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    meshes = (["16x16", "2x16x16"] if args.both_meshes
              else ["2x16x16" if args.multi_pod else "16x16"])
    done = load_results(args.out)

    total = ok = 0
    todo = []
    for arch in archs:
        for shp in shapes_for(get_config(arch)):
            if args.shape and shp.name != args.shape:
                continue
            for mesh in meshes:
                key = cell_key(arch, shp.name, mesh)
                total += 1
                if not args.force and key in done and done[key].get("ok"):
                    print(f"[cached] {key}")
                    ok += 1
                else:
                    todo.append((arch, shp.name, mesh))

    def report(key: str, rec: Dict[str, Any]) -> bool:
        if rec["ok"]:
            print(f"[done]   {key} flops/dev={rec['flops_per_device']:.3e} "
                  f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
                  f"args={rec['memory']['argument_bytes']/2**30:.2f}GiB "
                  f"trace={rec['trace_s']}s", flush=True)
        else:
            print(f"[failed] {key}: {rec['error']}", flush=True)
        store_result(key, rec, args.out)
        return rec["ok"]

    if todo:
        with concurrent.futures.ProcessPoolExecutor(
                min(len(todo), os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = {ex.submit(cell_record, *cell, args.device): cell for cell in todo}
            for fut in concurrent.futures.as_completed(futures):
                ok += report(cell_key(*futures[fut]), fut.result())
    print(f"\n{ok}/{total} cells green")
    if ok < total:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

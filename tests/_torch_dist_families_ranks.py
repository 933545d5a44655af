"""The rank side of tests/test_torch_dist_families.py: what each of 4 gloo
ranks runs for the ssm and moe families under a mesh.

`start` spawns `main` on 4 processes (a FileStore in the test's temp dir,
no port) and `join` waits for them; each rank reads the inputs the test
wrote, runs every case in one process group and writes what it saw to
`rank<r>.pt`.  This module imports no JAX; the JAX side of every comparison
runs in the pytest process.

A case is (arch, mesh shape, overrides of `reduced()`), at fp32 params:
* train — the sharded train state (`shard_train_state`), the loss and every
  gradient under the cell's activation specs beside the plain port's on the
  same weights and batch, every leaf's placements against its spec;
* serve (not for deepseek-v3-671b) — params and cache placed by
  `shard_params` and `shard_cache`, a prefill and 4 teacher-forced decode
  steps beside the plain port, the cache's placements, and every collective
  of the decode steps with its output's shape (a `CommDebugMode`).
For an MoE model every call of `layers._combine` (both paths) records which
routes were kept (a weight of 0 is a dropped route); each rank holds the
sharded step's kept routes, token by token, to the plain step's at its own
tokens, and counts the plain step's dropped routes.
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

WORLD = 4
TRAIN_CASES = (("mamba2-130m", (2, 2), ()), ("mamba2-130m", (1, 4), ()),
               ("mamba2-130m", (1, 4), (("d_model", 96),)),
               ("deepseek-v2-lite-16b", (2, 2), ()), ("deepseek-v2-lite-16b", (1, 4), ()),
               ("deepseek-v3-671b", (2, 2), ()))
SERVE_CASES = tuple(c for c in TRAIN_CASES if c[0] != "deepseek-v3-671b")
# the batch and sequence of a train case; a serve case's batch, prompt,
# decode steps and cache rows (no dim of the reduced models is 40, so a
# gathered cache would show in a shape)
B, S = 2, 64
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_T = 2, 12, 4, 40


def start(tmp: str):
    """`main` on WORLD spawned processes; `join` waits for them."""
    return torch.multiprocessing.start_processes(main, args=(tmp,), nprocs=WORLD, join=False,
                                                 start_method="spawn")


def join(ctx, timeout: float = 900.0) -> None:
    """Waits for the ranks; raises if one fails or they run past `timeout`
    seconds (their processes are killed then)."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} gloo ranks ran past {timeout} s")


def config(arch, overrides):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(**dict(overrides))


def main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {"rank": rank,
               "train": {case: train_case(*case, inputs) for case in TRAIN_CASES},
               "serve": {case: serve_case(*case, inputs) for case in SERVE_CASES}}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def collective_shapes():
    """A `CommDebugMode` that also keeps each collective's op name and
    output shape, in order, in `.shapes`."""
    from torch.distributed.tensor.debug import CommDebugMode

    class Shapes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.overloadpacket in self.comm_registry and isinstance(out, torch.Tensor):
                self.shapes.append((func.name(), tuple(out.shape)))
            return out
    return Shapes()


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


class KeptRoutes:
    """While entered, records the kept routes of every `layers._combine`
    call: its weights [t, k] are nonzero exactly where a route is kept."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.real, self.calls = layers, layers._combine, []

    def __enter__(self):
        def spy(rows, w):
            self.calls.append(w.detach() != 0)
            return self.real(rows, w)
        self.layers._combine = spy
        return self

    def __exit__(self, *exc):
        self.layers._combine = self.real


def _kept_against_plain(sharded, plain, mesh, x_shape, tokens_split) -> dict:
    """Each sharded call's kept routes [local tokens, k] against the plain
    call's at this rank's tokens: batch rows and, where `tokens_split`
    splits it, the sequence as DTensor chunks them."""
    coord = mesh.get_coordinate()
    b, s = x_shape
    rows, seq = slice(0, b), slice(0, s)
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name == "data" and n > 1 and b % n == 0:
            rows = slice(coord[i] * (b // n), (coord[i] + 1) * (b // n))
        if name == "model" and tokens_split and n > 1:
            seq = slice(coord[i] * (s // n), (coord[i] + 1) * (s // n))
    same = len(sharded) == len(plain) > 0
    for a, p in zip(sharded, plain):
        want = p.view(b, s, -1)[rows, seq].reshape(-1, p.shape[-1])
        same = same and torch.equal(a, want)
    return {"kept_equal": same, "plain_dropped": int(sum((~p).sum() for p in plain)),
            "calls": len(plain)}


def train_case(arch, shape, overrides, inputs) -> dict:
    """The sharded loss and every gradient of one reduced arch on one mesh
    at fp32 params, beside the plain port on the same weights and batch;
    every leaf's placements; the kept routes of an MoE model."""
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import (make_train_state, param_grads, shard_batch,
                                           shard_train_state, train_state_specs)
    from repro_torch.tree import tree_leaves
    cfg = config(arch, overrides)
    mesh = make_host_mesh(*shape, device_type="cpu")
    batch = inputs["batch"]
    ishape = InputShape("train", S, B, "train")
    params = inputs["params"][(arch, overrides)]
    state = shard_train_state(make_train_state(cfg, AdamWConfig(), params=_clone(params)), cfg,
                              mesh)
    rec = {"placement_faults": sh.misplaced(
        state, train_state_specs(params, cfg, sh.mesh_shape(mesh)), mesh)}
    with KeptRoutes() as sharded, activation_specs(
            sh.activation_specs_for(sh.mesh_shape(mesh), ishape, cfg)):
        loss, _ = loss_fn(state["params"], shard_batch(batch, mesh, ishape), cfg)
        grads = param_grads(loss, tree_leaves(state["params"]))
    rec["loss"] = float(loss.detach().full_tensor())
    rec["grads"] = [g.full_tensor() for g in grads]
    rec["grad_placements_ok"] = all(g.placements == p.placements
                                    for g, p in zip(grads, tree_leaves(state["params"])))
    plain = make_train_state(cfg, AdamWConfig(), params=_clone(params))
    with KeptRoutes() as kept:
        p_loss, _ = loss_fn(plain["params"], batch, cfg)
        p_grads = param_grads(p_loss, tree_leaves(plain["params"]))
    rec["plain_loss"], rec["plain_grads"] = float(p_loss.detach()), [g.detach() for g in p_grads]
    if cfg.moe is not None:
        rec["routes"] = _kept_against_plain(sharded.calls, kept.calls, mesh, (B, S), True)
    return rec


def serve_case(arch, shape, overrides, inputs) -> dict:
    """The sharded prefill and teacher-forced decode steps of one reduced
    arch on one mesh at fp32 params beside the plain port: each step's
    logits (whole), the cache's leaves against `cache_specs`, every
    collective of the decode steps with its output's shape, and the kept
    routes of an MoE model."""
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import shard_batch, shard_cache, shard_params

    cfg = config(arch, overrides)
    mesh = make_host_mesh(*shape, device_type="cpu")
    ms = sh.mesh_shape(mesh)
    params = _clone(inputs["params"][(arch, overrides)])
    toks = inputs["serve_tokens"]
    p, t = SERVE_PROMPT, SERVE_T
    pre, dec = (InputShape("prefill", p, SERVE_B, "prefill"),
                InputShape("decode", t, SERVE_B, "decode"))
    rec = {"logits": [], "plain_logits": []}
    with torch.no_grad():
        sparams = shard_params(params, cfg, mesh)
        cache = shard_cache(init_cache(cfg, SERVE_B, t, "cpu"), cfg, mesh, SERVE_B, t)
        plain = init_cache(cfg, SERVE_B, t, "cpu")
        with KeptRoutes() as sharded, activation_specs(sh.activation_specs_for(ms, pre, cfg)):
            lg, cache = prefill(sparams, shard_batch({"tokens": toks[:, :p]}, mesh, pre), cfg,
                                cache)
        rec["logits"].append(lg.full_tensor())
        with KeptRoutes() as kept:
            rec["plain_logits"].append(prefill(params, {"tokens": toks[:, :p]}, cfg, plain)[0])
        routes = [(sharded.calls, kept.calls, (SERVE_B, p), True)]
        comm = collective_shapes()
        for i in range(SERVE_STEPS):
            batch = shard_batch({"tokens": toks[:, p + i:p + i + 1]}, mesh, dec, for_decode=True)
            with KeptRoutes() as sharded, comm, activation_specs(
                    sh.activation_specs_for(ms, dec, cfg)):
                lg, cache = decode_step(sparams, batch, cfg, cache, p + i)
            rec["logits"].append(lg.full_tensor())
            with KeptRoutes() as kept:
                rec["plain_logits"].append(
                    decode_step(params, {"tokens": toks[:, p + i:p + i + 1]}, cfg, plain, p + i)[0])
            routes.append((sharded.calls, kept.calls, (SERVE_B, 1), False))
        rec["decode_collectives"] = comm.shapes
        rec["cache_faults"] = sh.misplaced(cache, sh.cache_specs(cfg, ms, SERVE_B, t), mesh)
        rec["param_faults"] = sh.misplaced(
            sparams, sh.param_specs(params, _axes(cfg), ms, sh.ShardingPolicy()), mesh)
        if cfg.moe is not None:
            parts = [_kept_against_plain(a, b, mesh, shp, split) for a, b, shp, split in routes]
            rec["routes"] = {"kept_equal": all(r["kept_equal"] for r in parts),
                             "plain_dropped": sum(r["plain_dropped"] for r in parts),
                             "calls": sum(r["calls"] for r in parts)}
    return rec


def _axes(cfg):
    from repro_torch.runtime.steps import model_axes
    return model_axes(cfg)

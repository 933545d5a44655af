"""The rank side of tests/test_torch_dist_hybrid.py: what each of 4 gloo
ranks runs for the hybrid family (reduced jamba-1.5-large-398b) under a
mesh.

`start` spawns `main` on 4 processes (a FileStore in the test's temp dir,
no port); each rank reads the inputs the test wrote, runs every case in
one process group and writes what it saw to `rank<r>.pt`.  The batch and
serve sizes, `join` and the helpers are tests/_torch_dist_families_ranks.py's.  This module imports no JAX; the JAX side of every comparison
runs in the pytest process.

A case is (mesh shape, overrides of `reduced()`), at fp32 params:
* train: the sharded train state (`shard_train_state`), the loss, its aux
  term and every gradient under the cell's activation specs beside the
  plain port's on the same weights and batch, every leaf's placements
  against its spec;
* serve: params and cache placed by `shard_params` and `shard_cache`, a
  prefill and 4 teacher-forced decode steps beside the plain port, each
  step's logits, the whole cache read back after the prefill and after the
  last step (its conv and scan states, its keys and values) beside the
  plain cache, its placements, each rank's local shard against the same
  rows of the plain cache, and every collective of the decode steps with
  its output's shape (a `CommDebugMode`).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from _torch_dist_families_ranks import (B, S, SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_T,
                                        WORLD, _clone, collective_shapes)

ARCH = "jamba-1.5-large-398b"
# (2, 2): 4 kv heads divide "model", the cache splits by heads; (1, 4) at 2
# kv heads: they do not divide 4, the cache splits by sequence and decode
# merges each rank's partial by its lse, as at full width (8 kv heads on 16)
TRAIN_CASES = (((2, 2), ()), ((1, 4), (("n_kv_heads", 2),)))
# the (1, 4) serve case at two period blocks: the cache's block index
SERVE_CASES = (((2, 2), ()), ((1, 4), (("n_kv_heads", 2), ("n_layers", 16))))


def start(tmp: str):
    """`main` on WORLD spawned processes (`join` waits for them)."""
    return torch.multiprocessing.start_processes(main, args=(tmp,), nprocs=WORLD, join=False,
                                                 start_method="spawn")


def config(overrides):
    from repro_torch.configs import get_config
    return get_config(ARCH).reduced(**dict(overrides))


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


def train_case(shape, overrides, inputs) -> dict:
    """The sharded loss, aux and every gradient of reduced jamba on one
    mesh at fp32 params, beside the plain port on the same weights and
    batch; every leaf's placements."""
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import (make_train_state, param_grads, shard_batch,
                                           shard_train_state, train_state_specs)
    from repro_torch.tree import tree_leaves
    cfg = config(overrides)
    mesh = make_host_mesh(*shape, device_type="cpu")
    batch = inputs["batch"]
    ishape = InputShape("train", S, B, "train")
    params = inputs["params"][overrides]
    state = shard_train_state(make_train_state(cfg, AdamWConfig(), params=_clone(params)), cfg,
                              mesh)
    rec = {"placement_faults": sh.misplaced(
        state, train_state_specs(params, cfg, sh.mesh_shape(mesh)), mesh)}
    with activation_specs(sh.activation_specs_for(sh.mesh_shape(mesh), ishape, cfg)):
        loss, metrics = loss_fn(state["params"], shard_batch(batch, mesh, ishape), cfg)
        grads = param_grads(loss, tree_leaves(state["params"]))
    rec["loss"] = float(loss.detach().full_tensor())
    rec["aux"] = float(metrics["aux"].detach().full_tensor())
    rec["grads"] = [g.full_tensor() for g in grads]
    rec["grad_placements_ok"] = all(g.placements == p.placements
                                    for g, p in zip(grads, tree_leaves(state["params"])))
    plain = make_train_state(cfg, AdamWConfig(), params=_clone(params))
    p_loss, p_metrics = loss_fn(plain["params"], batch, cfg)
    p_grads = param_grads(p_loss, tree_leaves(plain["params"]))
    rec["plain_loss"], rec["plain_grads"] = float(p_loss.detach()), [g.detach() for g in p_grads]
    rec["plain_aux"] = float(p_metrics["aux"].detach())
    return rec


def _local_against_plain(sharded, plain) -> dict:
    """{dotted leaf name: relative L2 error} of this rank's local shard of
    each cache leaf against the same rows of the plain port's cache: a new
    state written anywhere but the rank's own shard would not be there."""
    from repro_torch.models.layers import _local_rows
    out = {}

    def walk(t, p, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], p[k], f"{name}{k}.")
            return
        want = p
        for d in range(t.ndim):
            want = want.narrow(d, *_local_rows(t, d))
        got = t.to_local().float()
        out[name[:-1]] = float((got - want.float()).norm() / max(float(want.float().norm()),
                                                                1e-30))
    walk(sharded, plain, "")
    return out


def serve_case(shape, overrides, inputs) -> dict:
    """The sharded prefill and teacher-forced decode steps of reduced jamba
    on one mesh at fp32 params beside the plain port: each step's logits
    (whole), the cache after the prefill and after the last step (whole,
    beside the plain cache), its leaves against `cache_specs`, each local
    shard against the plain cache's same rows; every decode collective's
    output shape."""
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import model_axes, shard_batch, shard_cache, shard_params
    from repro_torch.tree import tree_map

    cfg = config(overrides)
    mesh = make_host_mesh(*shape, device_type="cpu")
    ms = sh.mesh_shape(mesh)
    params = _clone(inputs["params"][overrides])
    toks = inputs["serve_tokens"]
    p, t = SERVE_PROMPT, SERVE_T
    pre, dec = (InputShape("prefill", p, SERVE_B, "prefill"),
                InputShape("decode", t, SERVE_B, "decode"))
    rec = {"logits": [], "plain_logits": []}
    with torch.no_grad():
        sparams = shard_params(params, cfg, mesh)
        cache = shard_cache(init_cache(cfg, SERVE_B, t, "cpu"), cfg, mesh, SERVE_B, t)
        plain = init_cache(cfg, SERVE_B, t, "cpu")
        with activation_specs(sh.activation_specs_for(ms, pre, cfg)):
            lg, cache = prefill(sparams, shard_batch({"tokens": toks[:, :p]}, mesh, pre), cfg,
                                cache)
        rec["logits"].append(lg.full_tensor())
        rec["plain_logits"].append(prefill(params, {"tokens": toks[:, :p]}, cfg, plain)[0])
        rec["prefill_cache"] = tree_map(lambda c: c.full_tensor(), cache)
        comm = collective_shapes()
        for i in range(SERVE_STEPS):
            batch = shard_batch({"tokens": toks[:, p + i:p + i + 1]}, mesh, dec, for_decode=True)
            with comm, activation_specs(sh.activation_specs_for(ms, dec, cfg)):
                lg, cache = decode_step(sparams, batch, cfg, cache, p + i)
            rec["logits"].append(lg.full_tensor())
            rec["plain_logits"].append(
                decode_step(params, {"tokens": toks[:, p + i:p + i + 1]}, cfg, plain, p + i)[0])
        rec["decode_collectives"] = comm.shapes
        rec["cache"] = tree_map(lambda c: c.full_tensor(), cache)
        rec["plain_cache"] = plain
        rec["cache_faults"] = sh.misplaced(cache, sh.cache_specs(cfg, ms, SERVE_B, t), mesh)
        rec["local_rel_l2"] = _local_against_plain(cache, plain)
        rec["param_faults"] = sh.misplaced(
            sparams, sh.param_specs(params, model_axes(cfg), ms, sh.ShardingPolicy()), mesh)
    return rec

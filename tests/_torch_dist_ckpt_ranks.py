"""The rank side of tests/test_torch_dist_ckpt.py: what each of 4 gloo ranks
runs to save a sharded train state and restore it onto other meshes.

`start` spawns `main` on 4 processes (a FileStore in the test's temp dir,
no port); `join` (tests/_torch_dist_families_ranks.py's) waits for them.
Each rank reads the plain states the test wrote, runs every arch in one
process group and writes what it saw to `rank<r>.pt`.  This module imports
no JAX; the JAX side of every comparison runs in the pytest process.

For each arch (the state: JAX's reduced weights carried across, moments
drawn from a numpy seed, `opt.step` 7):
* save: the state through `shard_train_state` on (2, 2), saved as step
  STEP with `block=True` (run `<arch>-sync`) and with `block=False` (run
  `<arch>-async`), where a sharded `train_step` then updates the state in
  place before `wait()`; each save's record and `latest_step()` on every
  rank after it returns (after `wait()` for the async one);
* restore: `elastic_restore` of the blocking save onto (2, 2), (1, 4) and
  (4, 1), from a `like_state` of DTensors on the new mesh (a zero state)
  and from `abstract_state`'s fake tensors; and of the JAX save the test
  wrote (run `<arch>-jax`) onto (2, 2).  Each restore's leaves whose local
  shard is not bitwise the same slice of the plain state (cut by
  `torch.chunk`, mesh dim by mesh dim), its leaves off their spec's
  placements, whether `opt.step` is plain, the sampler's state, and how
  many leaves a rank holds only part of.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from _torch_dist_families_ranks import WORLD

ARCHS = ("chatglm3-6b", "mamba2-130m", "deepseek-v3-671b", "jamba-1.5-large-398b")
MESHES = ((2, 2), (1, 4), (4, 1))
STEP, GLOBAL_BATCH, N_SAMPLES = 3, 2, 16
B, S = 2, 64


def start(tmp: str):
    """`main` on WORLD spawned processes (`join` waits for them)."""
    return torch.multiprocessing.start_processes(main, args=(tmp,), nprocs=WORLD, join=False,
                                                 start_method="spawn")


def config(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced()


def extra():
    return {"train_step": STEP, "sampler": {"step": STEP, "seed": 11}}


def names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {"rank": rank, "archs": {a: arch_case(a, inputs[a], tmp) for a in ARCHS}}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def arch_case(arch, inp, tmp) -> dict:
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import InputShape
    from repro_torch.context import activation_specs
    from repro_torch.data import DirLib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import shard_batch, shard_train_state, train_step
    from repro_torch.tree import tree_leaves
    cfg, plain = config(arch), inp["state"]
    lib = DirLib(f"{tmp}/ckpt")
    mesh = make_host_mesh(2, 2, device_type="cpu")
    state = shard_train_state(_clone(plain), cfg, mesh)
    rec = {"sharded_leaves": sum(t.to_local().numel() < t.numel() for t in tree_leaves(state)
                                 if isinstance(t, DTensor))}
    sync = CheckpointManager(lib, f"{arch}-sync")
    sync.save(STEP, state, extra=extra())
    rec["sync"] = {"save": sync.saves[-1], "latest": sync.latest_step()}
    asy = CheckpointManager(lib, f"{arch}-async")
    asy.save(STEP, state, extra=extra(), block=False)
    # a train step updates the state in place while the files are written
    before = [t.to_local().clone() for t in tree_leaves(state["params"])]
    shape = InputShape("train", S, B, "train")
    with activation_specs(sh.activation_specs_for(sh.mesh_shape(mesh), shape, cfg)):
        new, _ = train_step(state, shard_batch(inp["batch"], mesh, shape), cfg, AdamWConfig())
    # params and moments are written in place (opt.step is a new tensor)
    in_place = all(a is b for a, b in zip(tree_leaves([new["params"], new["opt"]["m"]]),
                                          tree_leaves([state["params"], state["opt"]["m"]])))
    changed = sum(not torch.equal(b, t.to_local())
                  for b, t in zip(before, tree_leaves(state["params"])))
    asy.wait()
    rec["async"] = {"save": asy.saves[-1], "latest": asy.latest_step(), "in_place": in_place,
                    "params_changed": changed, "params": len(before)}
    rec["restore"] = {}
    for shape in MESHES:
        for like in ("dtensor", "fake"):
            rec["restore"][(shape, like, "sync")] = restore_case(arch, lib, "sync", shape, like,
                                                                 plain)
    rec["restore"][((2, 2), "dtensor", "jax")] = restore_case(arch, lib, "jax", (2, 2),
                                                               "dtensor", plain)
    return rec


def restore_case(arch, lib, run, shape, like_kind, plain) -> dict:
    """`elastic_restore` of run `<arch>-<run>` onto a mesh of `shape` from a
    like_state of `like_kind`, against the plain state."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.runtime.steps import (abstract_state, make_train_state, shard_train_state,
                                           train_state_specs)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = config(arch)
    mesh = make_host_mesh(*shape, device_type="cpu")
    specs = train_state_specs(plain["params"], cfg, sh.mesh_shape(mesh))
    if like_kind == "fake":
        like = abstract_state(cfg, AdamWConfig(), device="cpu")
    else:
        zero = make_train_state(cfg, AdamWConfig(), params=tree_map(
            lambda t: torch.zeros_like(t.detach()), plain["params"]))
        like = shard_train_state(zero, cfg, mesh)
    res = elastic_restore(CheckpointManager(lib, f"{arch}-{run}"), like, GLOBAL_BATCH,
                          N_SAMPLES, mesh, specs)
    wrong, partial = [], 0
    for name, got, want in zip(names(res.state), tree_leaves(res.state), tree_leaves(plain)):
        exp, grad = want.detach(), got.requires_grad
        if isinstance(got, DTensor):
            for i, p in enumerate(got.placements):
                if p.is_shard():
                    exp = exp.chunk(mesh.size(i), dim=p.dim)[mesh.get_coordinate()[i]]
            partial += exp.numel() < want.numel()
            got = got.to_local()
        if not (got.dtype == exp.dtype and torch.equal(got.detach(), exp)
                and grad == want.requires_grad):
            wrong.append(name)
    return {"wrong": wrong, "misplaced": sh.misplaced(res.state, specs, mesh),
            "opt_step_plain": not isinstance(res.state["opt"]["step"], DTensor),
            "step": res.step, "sampler": res.sampler.state_dict(), "partial": partial,
            "leaves": len(tree_leaves(res.state))}

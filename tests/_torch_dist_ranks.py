"""The rank side of tests/test_torch_dist.py: what each of 4 gloo ranks runs.

`start` spawns `main` on 4 processes (a FileStore in the test's temp dir,
no port) and `join` waits for them; each rank reads the inputs the test wrote, runs every check on
its meshes in one process group and writes what it saw to `rank<r>.pt`.
This module imports no JAX, so a rank starts in torch's time alone; the
JAX side of every comparison runs in the pytest process.

The checks, in one spawn:
* train — reduced chatglm3-6b and stablelm-3b on a (2, 2) (data, model)
  mesh and chatglm3-6b on (1, 4), whose 2 kv heads do not divide the model
  axis: the sharded loss and gradients and AdamW on DTensors fed the plain
  gradients (fp32 params), one sharded `train_step` (bf16 params), each
  beside the plain (unsharded) port on the same weights and batch, and
  every leaf's placements and local shape against its spec;
* compress — `compressed_psum_tree` over the "pod" dim of a (pod 2, data 2)
  mesh, on different grads on every rank;
* pipeline — `pipeline_forward` over the 4 stages of a ("pod",) mesh;
* elastic — `elastic_restore` of a checkpoint the test saved, onto (2, 2);
* constrain — `context.constrain` with and without specs, counted by
  DTensor's `CommDebugMode`;
* serve — the sharded serve path: reduced chatglm3-6b on (1, 4), whose 2
  kv heads leave the cache split by its sequence, and on (2, 2), heads
  split, and reduced stablelm-3b on (1, 4), heads split: params and cache
  placed by `shard_params` and `shard_cache`, a prefill and 4 decode steps
  (teacher-forced) under their activation specs beside the plain port on
  the same weights (fp32 and bf16), every collective of the decode steps
  recorded with its output's shape (a `CommDebugMode`).
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

WORLD = 4
TRAIN_CASES = (("chatglm3-6b", (2, 2)), ("stablelm-3b", (2, 2)), ("chatglm3-6b", (1, 4)))
SERVE_CASES = (("chatglm3-6b", (1, 4)), ("chatglm3-6b", (2, 2)), ("stablelm-3b", (1, 4)))
# the serve cases' batch, prompt, decode steps and cache rows (no other dim
# of the reduced models is 40, so a gathered cache would show in a shape)
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_T = 2, 12, 4, 40
COMPRESS_SHAPES = ((3, 300), (1000,), (7, 5, 11))   # none a multiple of 256 elements


def start(tmp: str):
    """`main` on WORLD spawned processes; `join` waits for them."""
    return torch.multiprocessing.start_processes(main, args=(tmp,), nprocs=WORLD, join=False,
                                                 start_method="spawn")


def join(ctx, timeout: float = 900.0) -> None:
    """Waits for the ranks; raises if one fails or they run past `timeout`
    seconds (their processes are killed then).  Alone they take ~50 s; the
    limit is a hang guard with room for a suite's workers on every core."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {WORLD} gloo ranks ran past {timeout} s")


def main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    try:
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        out = {"train": {}, "rank": rank}
        for arch, shape in TRAIN_CASES:
            for dt in ("f32", "bf16"):
                out["train"][(arch, shape, dt)] = train_case(arch, shape, dt, inputs)
        out["compress"] = compress_case(rank)
        out["pipeline"] = pipeline_case(inputs["pipeline"])
        out["elastic"] = elastic_case(tmp, inputs["elastic"])
        out["constrain"] = constrain_case()
        out["families"] = families_case()
        out["serve"] = {(*case, dt): serve_case(*case, dt, inputs)
                        for case in SERVE_CASES for dt in ("f32", "bf16")}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def train_case(arch, shape, dt, inputs) -> dict:
    """One arch on one mesh at one param dtype, beside the plain port on the
    same weights and batch: fp32, the sharded loss and every gradient, and
    AdamW on DTensors fed the plain gradients; bf16, one sharded
    `train_step`.  Full tensors come back on every rank."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import (make_train_state, model_axes, param_grads,
                                           shard_batch, shard_train_state, train_state_specs,
                                           train_step)
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = get_config(arch).reduced()
    mesh = make_host_mesh(*shape, device_type="cpu")
    batch = inputs["batch"]
    b, s = batch["tokens"].shape
    ishape = InputShape("train", s, b, "train")
    act = sh.activation_specs_for(sh.mesh_shape(mesh), ishape, cfg)
    opt_cfg = AdamWConfig(**inputs["opt"])
    params = inputs["params"][arch][dt]
    plain = make_train_state(cfg, opt_cfg, params=_clone(params))
    state = shard_train_state(make_train_state(cfg, opt_cfg, params=_clone(params)), cfg, mesh)
    specs = train_state_specs(params, cfg, sh.mesh_shape(mesh))
    sbatch = shard_batch(batch, mesh, ishape)
    rec = {"placement_faults": sh.misplaced(state, specs, mesh),
           "batch_faults": sh.misplaced(sbatch, sh.batch_shardings(sh.mesh_shape(mesh), ishape),
                                        mesh),
           "distribute_params_faults": sh.misplaced(
               sh.distribute_params(params, model_axes(cfg), mesh), specs["params"], mesh),
           "act_specs": act}
    leaves = tree_leaves(state["params"])
    if dt == "f32":
        with activation_specs(act):
            loss, _ = loss_fn(state["params"], sbatch, cfg)
            grads = param_grads(loss, leaves)
        rec["grad_placements_ok"] = all(g.placements == p.placements
                                        for g, p in zip(grads, leaves))
        rec["loss"] = float(loss.detach().full_tensor())
        rec["grads"] = [g.full_tensor() for g in grads]
        p_loss, _ = loss_fn(plain["params"], batch, cfg)
        p_grads = param_grads(p_loss, tree_leaves(plain["params"]))
        rec["plain_loss"], rec["plain_grads"] = float(p_loss), [g.detach() for g in p_grads]
        # AdamW on the shards, fed the plain gradients at the params' placements
        dgrads = [sh.distribute(g, mesh, list(p.placements)) for g, p in zip(p_grads, leaves)]
        new_p, new_opt, m = adamw_update(tree_unflatten(state["params"], dgrads),
                                         state["opt"], state["params"], opt_cfg)
        pp, popt, pm = adamw_update(tree_unflatten(plain["params"], list(p_grads)),
                                    plain["opt"], plain["params"], opt_cfg)
        rec["adamw"] = {
            "grad_norm": (float(m["grad_norm"]), float(pm["grad_norm"])),
            "leaves": [(a.detach().full_tensor(), b.detach()) for tree_a, tree_b in (
                (new_p, pp), (new_opt["m"], popt["m"]), (new_opt["v"], popt["v"]))
                for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b))],
            "placement_faults": sh.misplaced(new_p, specs["params"], mesh)}
    else:
        with activation_specs(act):
            new_state, metrics = train_step(state, sbatch, cfg, opt_cfg)
        p_state, p_metrics = train_step(plain, batch, cfg, opt_cfg)
        rec["step"] = {
            "loss": float(metrics["loss"]), "plain_loss": float(p_metrics["loss"]),
            "params": [t.detach().full_tensor() for t in tree_leaves(new_state["params"])],
            "plain_params": [t.detach() for t in tree_leaves(p_state["params"])],
            "placement_faults": sh.misplaced(new_state, specs, mesh),
            "metrics_plain": all(type(v) is torch.Tensor for v in metrics.values())}
    return rec


def compress_case(rank: int) -> dict:
    """Each rank's grads (drawn from its rank) through `compressed_psum_tree`
    over "pod" of a (pod 2, data 2) mesh; also what a mesh without the axis
    and one where it has size 1 give back."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime.compression import compressed_psum_tree
    g = torch.Generator().manual_seed(100 + rank)
    grads = {f"g{i}": (torch.randn(shape, generator=g) * (i + 1)).to(
        torch.bfloat16 if i == 0 else torch.float32) for i, shape in enumerate(COMPRESS_SHAPES)}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    out = compressed_psum_tree(grads, mesh, axis="pod")
    flat = init_device_mesh("cpu", (1, 4), mesh_dim_names=("pod", "data"))
    return {"grads": grads, "out": out, "coord": mesh.get_coordinate(),
            "absent_is_identity": compressed_psum_tree(grads, mesh, axis="model") is grads,
            "size1_is_identity": compressed_psum_tree(grads, flat, axis="pod") is grads}


def pipeline_case(inp) -> dict:
    """`pipeline_forward` of tanh(h @ w) over the 4 stages of ("pod",), from
    full `ws` and from `ws` as a DTensor sharded over the stages."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.runtime.pipeline_par import pipeline_forward
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pod",))

    def layer_fn(w, h):
        return torch.tanh(h @ w)
    ws, x = inp["ws"], inp["x"]
    out = pipeline_forward(layer_fn, ws, x, mesh=mesh, axis="pod", n_microbatches=4)
    dws = distribute_tensor(ws, mesh, [Shard(0)])
    out_d = pipeline_forward(lambda p, h: layer_fn(p["w"], h), {"w": dws}, x, mesh=mesh,
                             axis="pod", n_microbatches=4)
    return {"out": out, "out_dtensor": out_d}


def elastic_case(tmp: str, inp) -> dict:
    """`elastic_restore` of the checkpoint the test saved onto a (2, 2) mesh:
    each rank's local shards against slices of the state the test saved,
    and the sampler; and the mesh `remesh` builds for the 4 ranks."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DirLib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.elastic import elastic_restore, remesh
    from repro_torch.runtime.steps import make_train_state, train_state_specs
    from repro_torch.tree import tree_leaves
    cfg = get_config(inp["arch"]).reduced()
    mesh = make_host_mesh(2, 2, device_type="cpu")
    auto = remesh(WORLD, "cpu")
    like = make_train_state(cfg, AdamWConfig(), torch.Generator().manual_seed(1), "cpu")
    ckpt = CheckpointManager(DirLib(f"{tmp}/ckpt"), inp["run"])
    specs = train_state_specs(like["params"], cfg, sh.mesh_shape(mesh))
    res = elastic_restore(ckpt, like, inp["global_batch"], inp["n_samples"], mesh, specs)
    locals_ok, n_sharded = [], 0
    for got, want in zip(tree_leaves(res.state), tree_leaves(inp["saved"])):
        if not isinstance(got, DTensor):
            locals_ok.append(torch.equal(got, want))
            continue
        exp = want.detach()
        for i, p in enumerate(got.placements):
            if p.is_shard():
                exp = exp.chunk(mesh.size(i), dim=p.dim)[mesh.get_coordinate()[i]]
                n_sharded += 1
        locals_ok.append(torch.equal(got.to_local(), exp))
    return {"mesh": sh.mesh_shape(mesh), "remesh": sh.mesh_shape(auto), "step": res.step,
            "sampler": res.sampler.state_dict(),
            "leaves": len(locals_ok), "locals_bitwise": all(locals_ok),
            "shards": n_sharded, "opt_step_plain": not isinstance(res.state["opt"]["step"],
                                                                   DTensor)}


def constrain_case() -> dict:
    """Collectives `constrain` issues: none with no specs installed, none on
    a plain tensor; one redistribute with a spec that moves the tensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.context import activation_specs, constrain
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.randn(4, 8, 16), mesh, [Shard(0), Shard(2)])
    plain = torch.randn(4, 8, 16)
    rec = {}
    with CommDebugMode() as comm:
        rec["no_specs_same"] = constrain(x, "bsd") is x
        with activation_specs({"bsd": ("data", "model")}):
            rec["plain_same"] = constrain(plain, "bsd") is plain
            rec["none_spec_same"] = constrain(x, "heads") is x
    rec["no_op_collectives"] = comm.get_total_counts()
    with CommDebugMode() as comm:
        with activation_specs({"bsd": ("data", "model")}):
            y = constrain(x, "bsd")
    rec["moved_collectives"] = comm.get_total_counts()
    rec["moved_placements"] = [str(p) for p in y.placements]
    rec["moved_equal"] = torch.equal(y.full_tensor(), x.full_tensor())
    return rec


def families_case() -> dict:
    """`shard_train_state`, `shard_params` and `shard_cache` of each
    non-dense family's reduced model on a (2, 2) mesh: per arch the leaves
    not at their spec's placements, or the message of a refusal."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import (make_train_state, model_axes, shard_cache,
                                           shard_params, shard_train_state, train_state_specs)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    ms = sh.mesh_shape(mesh)
    out = {}
    for arch in ("mamba2-130m", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"):
        cfg = get_config(arch).reduced()
        try:
            with torch.no_grad():
                params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
            state = make_train_state(cfg, AdamWConfig(), params=params)
            faults = sh.misplaced(shard_train_state(state, cfg, mesh),
                                  train_state_specs(params, cfg, ms), mesh, prefix="state.")
            faults += sh.misplaced(shard_params(params, cfg, mesh),
                                   sh.param_specs(params, model_axes(cfg), ms,
                                                  sh.ShardingPolicy()), mesh, prefix="params.")
            faults += sh.misplaced(shard_cache(init_cache(cfg, 2, 16, "cpu"), cfg, mesh, 2, 16),
                                   sh.cache_specs(cfg, ms, 2, 16), mesh, prefix="cache.")
            out[arch] = faults
        except ValueError as e:
            out[arch] = str(e)
    return out


def serve_case(arch, shape, dt, inputs) -> dict:
    """The sharded prefill and decode steps of `arch` on a `shape` mesh
    beside the plain port on the same `dt` weights and tokens; each step's
    logits (whole), the cache's placements, and the shape of every
    collective's output in the decode steps."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import InputShape, get_config
    from repro_torch.context import activation_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import shard_batch, shard_cache, shard_params

    class Shapes(CommDebugMode):
        """CommDebugMode that also keeps each collective's output shape."""

        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.overloadpacket in self.comm_registry and isinstance(out, torch.Tensor):
                self.shapes.append((func.name(), tuple(out.shape)))
            return out

    cfg = get_config(arch).reduced()
    mesh = make_host_mesh(*shape, device_type="cpu")
    ms = sh.mesh_shape(mesh)
    params = _clone(inputs["params"][arch][dt])
    toks = inputs["serve"]["tokens"]
    p, t = SERVE_PROMPT, SERVE_T
    pre, dec = InputShape("prefill", p, SERVE_B, "prefill"), InputShape("decode", t, SERVE_B,
                                                                       "decode")
    rec = {"logits": [], "plain_logits": []}
    with torch.no_grad():
        sparams = shard_params(params, cfg, mesh)
        cache = shard_cache(init_cache(cfg, SERVE_B, t, "cpu"), cfg, mesh, SERVE_B, t)
        plain = init_cache(cfg, SERVE_B, t, "cpu")
        rec["cache_placements"] = [str(x) for x in cache["kv"]["k"].placements]
        with activation_specs(sh.activation_specs_for(ms, pre, cfg)):
            lg, cache = prefill(sparams, shard_batch({"tokens": toks[:, :p]}, mesh, pre), cfg,
                                cache)
        rec["logits"].append(lg.full_tensor())
        rec["plain_logits"].append(prefill(params, {"tokens": toks[:, :p]}, cfg, plain)[0])
        comm = Shapes()
        for i in range(SERVE_STEPS):
            batch = shard_batch({"tokens": toks[:, p + i:p + i + 1]}, mesh, dec, for_decode=True)
            with comm, activation_specs(sh.activation_specs_for(ms, dec, cfg)):
                lg, cache = decode_step(sparams, batch, cfg, cache, p + i)
            rec["logits"].append(lg.full_tensor())
            rec["plain_logits"].append(
                decode_step(params, {"tokens": toks[:, p + i:p + i + 1]}, cfg, plain, p + i)[0])
        rec["decode_collectives"] = comm.shapes
        rec["cache_is_dtensor"] = isinstance(cache["kv"]["k"], DTensor)
    return rec

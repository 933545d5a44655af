"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU, on fake
process groups of 4 ranks, against the JAX package's cells.

Reduced chatglm3-6b and stablelm-3b cells (train, prefill, decode) on
(2, 2) and (1, 4) meshes are traced as rank 0 and must be ok, with the
kernel calls of one step; chatglm3-6b's three (2, 2) cells also hold each
rank's argument bytes to JAX's `memory_analysis()` of the same cell,
compiled on the suite's 4 host devices.  JAX's cell is rebuilt here from
`repro.runtime.steps` and `repro.runtime.sharding`, as its `build_cell`
builds it: `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices when
imported, which would reach every later test of this worker.

The argument bytes differ only by the leaves named in `NAMED`: the port's
tokens and labels are int64 (what its Server and Trainer feed the
embedding), JAX's int32; JAX's decode step takes the position as an int32
argument, the port as a Python int.

Also here, at the reduced size: `chip_smoke.py`'s `dryrun` phase's cells
and checks, and its `serve_sharded` phase over a one-rank gloo group (the
sharded serve path on a 1 x 1 mesh, bitwise the unsharded Server).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.context import activation_specs as jax_activation_specs
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import sharding as jsh
from repro.runtime.steps import (abstract_batch, abstract_cache, abstract_state,
                                 make_train_step_fn, model_axes, prefill_step, serve_step)
from repro_torch.configs import InputShape, get_config
from repro_torch.launch.dryrun import cell_record, run_cell

SHAPES = {"train": InputShape("train", 64, 8, "train"),
          "prefill": InputShape("prefill", 64, 4, "prefill"),
          "decode": InputShape("decode", 64, 4, "decode")}
MESHES = [(2, 2), (1, 4)]


def _calls(cfg, kind):
    """One step's kernel calls (chip_smoke's dense_*_launches)."""
    n, rms = cfg.n_layers, cfg.norm == "rmsnorm"
    if kind == "train":
        out = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
               "flash_attention_bwd_dkv": n, "fused_ce": 16, "fused_ce_bwd": 8}
        return {**out, "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1} if rms else out
    out = {"flash_attention_fwd" if kind == "prefill" else "decode_attention": n}
    return {**out, "rmsnorm": 2 * n + 1} if rms else out


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch in ("chatglm3-6b", "stablelm-3b"):
        for mesh in MESHES:
            for kind, shape in SHAPES.items():
                out[(arch, mesh, kind)] = run_cell(arch, shape, mesh_shape=mesh, device="cpu",
                                                   reduced=True)
                assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b"])
def test_cell_is_ok_with_one_steps_kernel_calls(records, arch, mesh, kind):
    rec = records[(arch, mesh, kind)]
    assert rec["ok"] and rec["devices"] == 4 and rec["mesh"] == "x".join(map(str, mesh))
    assert rec["kernel_calls"] == _calls(get_config(arch).reduced(), kind)
    assert rec["flops_per_device"] > 0 and rec["bytes_accessed_per_device"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    # the train state and the cache are updated in place (JAX donates them)
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]


def _jax_argument_bytes(kind: str) -> int:
    """JAX's per-device argument bytes of reduced chatglm3-6b's cell on a
    (2, 2) mesh of host devices, built as `repro.launch.dryrun.build_cell`
    builds it (fp32 moments: chatglm3-6b is not a bf16-moment arch)."""
    cfg, shape = jax_get_config("chatglm3-6b").reduced(), SHAPES[kind]
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    policy, opt_cfg = jsh.ShardingPolicy(), JaxAdamWConfig(moment_dtype=jnp.float32)

    def named(tree):
        return jax.tree_util.tree_map(lambda s: jax.NamedSharding(mesh, s), tree,
                                      is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    state = abstract_state(cfg, opt_cfg)
    pshard = named(jsh.param_specs(state["params"], model_axes(cfg), mesh, policy))
    decode = kind == "decode"
    batch = abstract_batch(cfg, shape, for_decode=decode)
    bshard = {k: jsh.batch_shardings(mesh, shape, for_decode=decode).get(
        k, jax.NamedSharding(mesh, jax.sharding.PartitionSpec())) for k in batch}
    rep = jax.NamedSharding(mesh, jax.sharding.PartitionSpec())
    with mesh, jax_activation_specs(jsh.activation_specs_for(mesh, shape, cfg)):
        if kind == "train":
            sshard = {"params": pshard, "opt": {"m": pshard, "v": pshard, "step": rep}}
            fn = jax.jit(make_train_step_fn(cfg, opt_cfg), in_shardings=(sshard, bshard),
                         out_shardings=(sshard, None), donate_argnums=(0,))
            args = (state, batch)
        else:
            cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
            cshard = jsh.cache_shardings(cfg, mesh, shape.global_batch, shape.seq_len)
            if decode:
                fn = jax.jit(lambda p, c, b, pos: serve_step(p, c, b, pos, cfg),
                             in_shardings=(pshard, cshard, bshard, None),
                             out_shardings=(None, cshard), donate_argnums=(1,))
                args = (state["params"], cache, batch, jax.ShapeDtypeStruct((), jnp.int32))
            else:
                fn = jax.jit(lambda p, c, b: prefill_step(p, c, b, cfg),
                             in_shardings=(pshard, cshard, bshard),
                             out_shardings=(None, cshard), donate_argnums=(1,))
                args = (state["params"], cache, batch)
        return fn.lower(*args).compile().memory_analysis().argument_size_in_bytes


def _named(kind: str) -> int:
    """The port's argument bytes less JAX's, leaf by named leaf, on a (2, 2)
    mesh (the batch split over "data": B / 2 rows a rank)."""
    shape = SHAPES[kind]
    rows = shape.global_batch // 2
    if kind == "train":          # tokens and labels: int64 against int32
        return 2 * rows * shape.seq_len * 4
    if kind == "prefill":        # tokens
        return rows * shape.seq_len * 4
    return rows * 4 - 4          # tokens [B, 1]; JAX's int32 position, a Python int here


NAMED = {"train": "tokens, labels (int64 / int32)", "prefill": "tokens (int64 / int32)",
         "decode": "tokens (int64 / int32), pos (JAX's int32 argument)"}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_argument_bytes_are_jaxs_but_named_leaves(records, kind):
    got = records[("chatglm3-6b", (2, 2), kind)]["memory"]["argument_bytes"]
    want = _jax_argument_bytes(kind)
    print(f"{kind}: port {got}, JAX {want}, named leaves {NAMED[kind]}: {_named(kind)}")
    assert got - want == _named(kind)


@pytest.mark.parametrize("arch", ["mamba2-130m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_other_families_refuse_a_mesh_and_leave_no_group(arch):
    """The ssm, moe and hybrid families raise under a mesh larger than 1 (a
    reduced cell on (2, 2)), and a sweep records the refusal as a failed
    cell; no process group is left either way."""
    family = get_config(arch).family
    with pytest.raises(ValueError, match=family):
        run_cell(arch, SHAPES["train"], mesh_shape=(2, 2), device="cpu", reduced=True)
    assert not dist.is_initialized()
    if arch == "mamba2-130m":
        rec = cell_record(arch, "train_4k", "16x16", "cpu")
        assert rec["ok"] is False and "ValueError" in rec["error"] and family in rec["error"]
        assert not dist.is_initialized()


def test_a_cell_refuses_to_replace_a_live_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            run_cell("chatglm3-6b", SHAPES["decode"], mesh_shape=(1, 1), device="cpu",
                     reduced=True)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# chip_smoke.py's dryrun and serve_sharded phases, reduced, on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy_kernels(monkeypatch):
    """Counts each kernel wrapper's calls through the model's imports (a CPU
    tensor runs the plain version, which counts no launch)."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import layers
    calls = {}

    def spy(mod, attr, name):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)
    spy(rms_ops, "rmsnorm", "rmsnorm")
    spy(layers, "flash_attention_fwd", "flash_attention_fwd")
    spy(layers, "decode_attention", "decode_attention")
    return calls


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group for the test, destroyed after it."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_serve_sharded_runs_on_a_one_rank_mesh(monkeypatch, world_of_one):
    """Reduced chatglm3-6b, 8 new tokens: the serve phase's Server.generate, then
    `serve_sharded` with the same weights and prompts on a 1 x 1 mesh
    (params and cache DTensors): the same tokens, the last logits bitwise
    on the CPU, `dense_serve_launches`; a planted token or logit fault is
    named."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    cs = _chip_smoke()
    cfg = get_config(cs.ARCH).reduced()
    prompt, max_len, new = 16, 96, 8
    srv = Server(cs.ARCH, max_len=max_len, device="cpu", seed=cs.SEED)
    prompts = np.random.default_rng(cs.SEED + 1).integers(
        1, cfg.vocab_size, size=(cs.BATCH, prompt + 1)).astype(np.int32)[:, :prompt]
    out = srv.generate(prompts, new)
    ref = {"tokens": out["tokens"], "last_logits": out["last_logits"].float()}
    calls = _spy_kernels(monkeypatch)
    rec = cs.serve_sharded(torch.device("cpu"), ref, reduced=True, prompt=prompt,
                           max_len=max_len, new=new, counter=(calls.clear, lambda: dict(calls)))
    want = cs.dense_serve_launches(cfg, new)
    assert cs.sharded_serve_failures(rec, want) == []
    assert rec["tokens_equal"] and rec["logits_bitwise"]
    assert rec["mesh"] == {"data": 1, "model": 1}
    bad = dict(rec, tokens_equal=False, logits_rel_err=2e-5)
    assert len(cs.sharded_serve_failures(bad, want)) == 2


def test_dryrun_cells_hold_the_train_steps_bytes_calls_and_flops():
    """`dryrun_cells` at the reduced size on the CPU: the 1 x 1 train cell's
    argument bytes equal a real state's (bf16 moments) and batch's, its
    kernel calls `dense_train_launches`, its FLOPs within TOL_DRYRUN_FLOPS of
    `dense_train_flops` (what the card's run gates), the prefill and decode
    cells one prefill's and one decode step's calls; planted faults are
    named."""
    import itertools

    import torch
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    cs = _chip_smoke()
    tc = TrainerConfig(arch=cs.ARCH, reduced=True, global_batch=cs.TRAIN_B, seq_len=cs.TRAIN_S,
                       device="cpu", seed=cs.SEED, moment_dtype=torch.bfloat16)
    fixed = cs.fixed_batch(512, cs.TRAIN_B, cs.TRAIN_S, cs.SEED + 4)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    tr.init_state()
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(tr.state) + list(tr._to_device(fixed).values()))
    rec = cs.dryrun_cells(torch.device("cpu"), {"argument_bytes": arg_bytes, "peak_bytes": 1},
                          {}, reduced=True)
    rec["measured_peak_bytes"] = rec["train_peak_bytes"]      # no allocator to read here
    rec["peak_rel_err"] = 0.0
    print({k: v for k, v in rec.items() if k != "cells"})
    assert cs.dryrun_failures(rec) == []
    assert rec["flops_rel_err"] <= cs.TOL_DRYRUN_FLOPS
    for fault, key, value in (("argument", "train_argument_bytes", arg_bytes + 2),
                              ("peak", "peak_rel_err", 0.11),
                              ("flops", "flops_rel_err", 0.06)):
        bad = dict(rec, **{key: value})
        [msg] = cs.dryrun_failures(bad)
        assert fault in msg.lower()
    bad = dict(rec, kernel_calls=dict(rec["kernel_calls"], decode={"decode_attention": 3}))
    [msg] = cs.dryrun_failures(bad)
    assert "decode cell" in msg

"""The port's dry run (`repro_torch.launch.dryrun`) of the ssm, moe and
hybrid families on the CPU, on fake process groups of 4 ranks, against the
JAX package's cells.

Reduced mamba2-130m's, deepseek-v2-lite-16b's and jamba-1.5-large-398b's
train and decode cells on a (2, 2) mesh are traced as rank 0 and must be
ok, with the kernel calls of one step: mamba2's and jamba's 8 SSD heads
divide "model", so each rank scans its heads; the MoE layers' exchange is
traced at a balanced routing's sizes (no count is read from a fake tensor).
deepseek's cells keep MLA at the full model's head dims (`MLA_FULL_HEADS`):
a fake call meets the kernels' checks, and the flash kernels take <192,
128>, not the reduced model's <48, 32>.
One cell of each family also holds each rank's argument bytes to JAX's
`memory_analysis()` of the same cell, compiled on the suite's 4 host devices
(mamba2's train cell: the train state's placements; deepseek's decode cell:
the params' and the MLA cache's; jamba's decode cell: the params' and the
hybrid cache's KV, conv and scan states).  As in tests/test_torch_dryrun.py
the JAX cell is rebuilt here from `repro.runtime.steps` and
`repro.runtime.sharding`, and the argument bytes differ only by the named
leaves: the port's tokens and labels are int64, JAX's int32, and JAX's
decode step takes the position as an int32 argument.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.context import activation_specs as jax_activation_specs
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import sharding as jsh
from repro.runtime.steps import (abstract_batch, abstract_cache, abstract_state,
                                 make_train_step_fn, model_axes, serve_step)
from repro_torch.configs import InputShape, MLAConfig, get_config
from repro_torch.launch.dryrun import run_cell

SHAPES = {"train": InputShape("train", 64, 8, "train"),
          "decode": InputShape("decode", 64, 4, "decode")}
ARCHS = ("mamba2-130m", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")
# the cell of each family compiled by JAX for its argument bytes
JAX_CELLS = (("mamba2-130m", "train"), ("deepseek-v2-lite-16b", "decode"),
             ("jamba-1.5-large-398b", "decode"))
# reduced deepseek-v2-lite-16b with MLA at the full model's head dims (q/k
# 128 + 64 against v 128, as chip_smoke's moe_small_config): the flash
# kernels take <192, 128>, not the reduced <48, 32>, and a fake call meets
# the card's checks
MLA_FULL_HEADS = {"deepseek-v2-lite-16b": dict(kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=128,
                                               qk_rope_dim=64, v_head_dim=128)}


def _reduced(get, mla, arch):
    """`arch`'s reduced config (`get`, `mla`: one package's `get_config` and
    `MLAConfig`), its MLA at MLA_FULL_HEADS' dims where it names the arch."""
    heads = MLA_FULL_HEADS.get(arch)
    return get(arch).reduced(**({"mla": mla(**heads)} if heads else {}))


def _calls(cfg, kind):
    """One step's kernel calls (chip_smoke's ssm_train_launches,
    moe_train_launches, hybrid_train_launches; an ssm or MLA decode step
    runs only the norms, a hybrid one also decode attention a block)."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        nb = n // hy.period
        norms = nb * (2 * hy.period + hy.period - 1)
        if kind == "train":
            return {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
                    "flash_attention_fwd": 2 * nb, "flash_attention_bwd_dq": nb,
                    "flash_attention_bwd_dkv": nb, "ssd_scan": 2 * nb * (hy.period - 1),
                    "ssd_scan_bwd": nb * (hy.period - 1), "fused_ce": 16, "fused_ce_bwd": 8}
        return {"rmsnorm": norms + 1, "decode_attention": nb}
    if cfg.family == "ssm":
        if kind == "train":
            return {"rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1, "ssd_scan": 2 * n,
                    "ssd_scan_bwd": n, "fused_ce": 16, "fused_ce_bwd": 8}
        return {"rmsnorm": 2 * n + 1}
    norms = 3 + bool(cfg.mla.q_lora_rank)
    if kind == "train":
        return {"rmsnorm": 2 * norms * n + 1, "rmsnorm_bwd": norms * n + 1,
                "flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n, "fused_ce": 16, "fused_ce_bwd": 8}
    return {"rmsnorm": norms * n + 1}


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch in ARCHS:
        for kind, shape in SHAPES.items():
            out[(arch, kind)] = run_cell(arch, shape, mesh_shape=(2, 2), device="cpu",
                                         config=_reduced(get_config, MLAConfig, arch))
            assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_is_ok_with_one_steps_kernel_calls(records, arch, kind):
    rec = records[(arch, kind)]
    cfg = _reduced(get_config, MLAConfig, arch)
    assert rec["ok"] and rec["devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["kernel_calls"] == _calls(cfg, kind)
    assert rec["flops_per_device"] > 0 and rec["bytes_accessed_per_device"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    if cfg.moe is not None:
        assert "balanced" in rec["note"]
        if kind == "train":         # the kept routes move to their experts' ranks
            assert rec["collective_bytes_per_device"]["all-to-all"] > 0


def _jax_argument_bytes(arch: str, kind: str) -> int:
    """JAX's per-device argument bytes of the reduced cell on a (2, 2) mesh of
    host devices, built as `repro.launch.dryrun.build_cell` builds it (fp32
    moments: no train cell here is jamba's, whose sweep keeps them bf16)."""
    cfg, shape = _reduced(jax_get_config, JaxMLAConfig, arch), SHAPES[kind]
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
            fn = jax.jit(lambda p, c, b, pos: serve_step(p, c, b, pos, cfg),
                         in_shardings=(pshard, cshard, bshard, None),
                         out_shardings=(None, cshard), donate_argnums=(1,))
            args = (state["params"], cache, batch, jax.ShapeDtypeStruct((), jnp.int32))
        return fn.lower(*args).compile().memory_analysis().argument_size_in_bytes


def _named(kind: str) -> int:
    """The port's argument bytes less JAX's, leaf by named leaf, on a (2, 2)
    mesh (the batch split over "data": B / 2 rows a rank)."""
    shape = SHAPES[kind]
    rows = shape.global_batch // 2
    if kind == "train":          # tokens and labels: int64 against int32
        return 2 * rows * shape.seq_len * 4
    return rows * 4 - 4          # tokens [B, 1]; JAX's int32 position, a Python int here


@pytest.mark.parametrize("arch,kind", JAX_CELLS)
def test_argument_bytes_are_jaxs_but_named_leaves(records, arch, kind):
    got = records[(arch, kind)]["memory"]["argument_bytes"]
    want = _jax_argument_bytes(arch, kind)
    print(f"{arch} {kind}: port {got}, JAX {want}, named leaves: {_named(kind)}")
    assert got - want == _named(kind)



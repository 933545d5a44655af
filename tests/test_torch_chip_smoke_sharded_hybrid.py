"""`chip_smoke.py`'s hybrid phases under a mesh on the CPU, at the reduced
size over a one-rank gloo group: train_hybrid then train_sharded_hybrid
(`hybrid_small_config()`: GQA rep 8 at D 128, SSD P 64, N 16), serve_hybrid's
run then serve_sharded_hybrid, dryrun_hybrid's cell; the RMSNorm backward's
two kernel instances in the ptxas report and its spill gate; the hybrid
family's train FLOPs.  Its own file, apart from tests/test_torch_chip_smoke.py
and tests/test_torch_chip_smoke_hybrid.py: a file runs on one worker."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import itertools
import types
from pathlib import Path

import pytest

from test_torch_chip_smoke import _spy_kernels

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def world_of_one(tmp_path):
    """A one-rank gloo process group for the test, destroyed after it."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _train_hybrid(cs, b, s, steps, layers):
    """train_hybrid's run at (b, s): the unsharded Trainer on the fixed batch,
    bf16 moments, every route recorded; its losses, a host copy of its
    params, its argument bytes and its routes."""
    import torch
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    tc = TrainerConfig(arch=cs.HYBRID_ARCH, reduced=False, global_batch=b, seq_len=s,
                       steps=steps, log_every=steps, device="cpu", seed=cs.SEED,
                       moment_dtype=torch.bfloat16)
    fixed = cs.fixed_batch(cs.hybrid_small_config().vocab_size, b, s, cs.SEED + 62)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    tr.init_state()
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(tr.state) + list(tr._to_device(fixed).values()))
    with cs.RouteRecorder(layers) as recorder:
        out = tr.run()
    return {"losses": out["losses"], "params": cs.host_copy(tr.state["params"]),
            "argument_bytes": arg_bytes, "routes": recorder.take()}


def test_train_sharded_hybrid_is_bitwise_train_hybrid_on_a_one_rank_mesh(monkeypatch,
                                                                        world_of_one):
    """`hybrid_small_config()` (one period block with the full model's head
    dims): the unsharded Trainer's 2 steps, then `train_sharded` from the
    same weights and batch on a 1 x 1 mesh: every loss and param leaf
    bitwise, every leaf at its placements, `hybrid_train_launches` a step,
    the same routes call by call (each MoE layer forward and recomputed)."""
    import torch
    from repro_torch.models import layers

    cs = _chip_smoke()
    b, s, steps = 2, 64, 2
    with cs.config_as(cs.HYBRID_ARCH, cs.hybrid_small_config()) as cfg:
        ref = _train_hybrid(cs, b, s, steps, layers)
        calls = _spy_kernels(monkeypatch)
        with cs.RouteRecorder(layers) as recorder:
            rec = cs.train_sharded(torch.device("cpu"), ref, arch=cs.HYBRID_ARCH, batch=b,
                                   seq=s, steps=steps, batch_seed=cs.SEED + 62,
                                   counter=(calls.clear, lambda: dict(calls)))
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (8, 1, 128)
    assert cs.sharded_failures(rec, cs.hybrid_train_launches(cfg)) == []
    assert rec["losses_bitwise"] and rec["params_bitwise"]
    assert rec["moment_dtype"] == "bfloat16"
    routes = recorder.take()
    assert len(routes) == len(ref["routes"]) == 2 * steps * cs.moe_layer_count(cfg)
    assert cs.route_flips(ref["routes"], routes) == []


def test_serve_sharded_hybrid_is_bitwise_the_server_on_a_one_rank_mesh(monkeypatch,
                                                                      world_of_one):
    """`hybrid_small_config()` served 8 new tokens by Server.generate, then
    `serve_sharded` with the same weights and prompts on a 1 x 1 mesh (a
    cache of DTensors: the KV and the [NB, 7, ...] conv and scan states):
    the same tokens, the last logits bitwise, the same launches."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Server

    cs = _chip_smoke()
    prompt, max_len, new = 16, 40, 8
    with cs.config_as(cs.HYBRID_ARCH, cs.hybrid_small_config()) as cfg:
        srv = Server(cs.HYBRID_ARCH, reduced=False, max_len=max_len, device="cpu",
                     seed=cs.SEED)
        prompts = np.random.default_rng(cs.SEED + 34).integers(
            1, cfg.vocab_size, size=(cs.BATCH, prompt + 1)).astype(np.int32)[:, :prompt]
        calls = _spy_kernels(monkeypatch)
        out = srv.generate(prompts, new)
        want = dict(calls)
        ref = {"tokens": out["tokens"], "last_logits": out["last_logits"].float()}
        rec = cs.serve_sharded(torch.device("cpu"), ref, arch=cs.HYBRID_ARCH, prompt=prompt,
                               max_len=max_len, new=new, prompt_seed=cs.SEED + 34,
                               counter=(calls.clear, lambda: dict(calls)))
    assert cs.sharded_serve_failures(rec, want) == []
    assert rec["tokens_equal"] and rec["logits_bitwise"]
    assert want["decode_attention"] == new and want["ssd_scan"] == cfg.hybrid.period - 1


def test_dryrun_hybrid_cell_holds_train_hybrids_bytes_and_calls():
    """`dryrun_hybrid_cell` at the reduced size on the CPU: the 1 x 1 train
    cell of `hybrid_small_config()` (bf16 moments), its argument bytes equal
    a real state's and batch's, its kernel calls `hybrid_train_launches`,
    and no FLOPs gate (the record names none)."""
    import torch
    from repro_torch.models import layers

    cs = _chip_smoke()
    b, s = 2, 64
    with cs.config_as(cs.HYBRID_ARCH, cs.hybrid_small_config()) as cfg:
        ref = _train_hybrid(cs, b, s, 1, layers)
    rec = cs.dryrun_hybrid_cell(torch.device("cpu"), {
        "argument_bytes": ref["argument_bytes"], "peak_bytes": 1}, cfg, batch=b, seq=s)
    rec["peak_rel_err"] = 0.0                   # no allocator to read here
    print({k: v for k, v in rec.items() if k != "cells"})
    assert cs.dryrun_failures(rec) == []
    assert rec["train_argument_bytes"] == ref["argument_bytes"]
    assert rec["analytic_flops"] is None and rec["train_flops"] > 0
    assert rec["cells"]["train"]["moment_dtype"] == "bfloat16"
    rec["kernel_calls"]["train"]["rmsnorm_bwd"] += 1
    assert any("kernel calls" in f for f in cs.dryrun_failures(rec))


def _mangled(v):
    name = "rmsnorm_bwd_kernel"
    return f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{v}EEvPK13__nv_bfloat16S3_S3_PS1_PfS4_Pjiiiif"


@pytest.mark.parametrize("spill_v", [None, 2, 4])
def test_ptxas_report_reads_both_rmsnorm_bwd_instances_and_gates_their_spills(tmp_path,
                                                                            spill_v):
    """The RMSNorm backward has an instance at two and at four vectors a
    thread (d <= 8192, d <= 16384): the ptxas report gives each its V, and
    the spill gate fails either one that spills, naming it."""
    cs = _chip_smoke()
    log = "".join(
        f"ptxas info    : Compiling entry function '{_mangled(v)}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {8 * (v == spill_v)} bytes spill stores, "
        f"{8 * (v == spill_v)} bytes spill loads\n"
        f"ptxas info    : Used 96 registers, used 2 barriers\n" for v in (2, 4))
    (tmp_path / "rmsnorm.cu.log").write_text(log)
    (tmp_path / "decode_attention.cu.log").write_text("")
    rows = cs.ptxas_report(types.SimpleNamespace(BUILD_DIR=tmp_path))
    assert [(r["kernel"], r["V"]) for r in rows] == [("rmsnorm_bwd_kernel", 2),
                                                     ("rmsnorm_bwd_kernel", 4)]
    for r in rows:
        if r["V"] == spill_v:
            with pytest.raises(AssertionError, match=rf"rmsnorm_bwd_kernel<{spill_v}> spills"):
                cs.check_no_spills(r)
        else:
            cs.check_no_spills(r)


def test_hybrid_train_flops_count_the_top_k_experts_and_no_table():
    """`model_flops` of a hybrid model: 6 x the params a token's products
    read (every leaf but the token table, each MoE layer's experts at top_k
    of n_experts) x tokens, plus the SSD products of the 7 Mamba layers and
    the attention layer's causal pairs, counted here from the leaves."""
    from repro_torch.runtime.steps import abstract_params
    from repro_torch.tree import tree_leaves

    cs = _chip_smoke()
    cfg = cs.hybrid_small_config()
    params = abstract_params(cfg, device="cpu")
    n_params = sum(t.numel() for t in tree_leaves(params))
    mo = cfg.moe
    read = n_params - params["embed"]["tok"].numel()
    for lp in params["blocks"][0]["layers"]:
        if "router" in lp["ffn"]:
            experts = sum(lp["ffn"][k].numel() for k in ("wi_gate", "wi_up", "wo"))
            read -= experts * (mo.n_experts - mo.top_k) // mo.n_experts
    b, s, chunk = 2, 256, cs.SSD_CHUNK
    p, n = cfg.ssm.head_dim, cfg.ssm.d_state
    h = cfg.ssm.expand * cfg.d_model // p
    ssd = b * (s // chunk) * (chunk * chunk * n + h * (chunk * chunk * p + 2 * chunk * n * p))
    pairs = b * cfg.n_heads * s * (s + 1) // 2
    want = 6 * read * b * s + 6 * ssd * (cfg.hybrid.period - 1) + 12 * cfg.head_dim * pairs
    assert cs.model_flops(cfg, n_params, b, s) == want

"""`chip_smoke.py`'s bookkeeping that needs no card: the kernel resource
report read from `ptxas -v` logs, its spill gate, and the SSD backward's
count of work.  The logs here are written by the test in ptxas's format."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mangled(kernel, vals):
    return f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}I" + "".join(f"Li{v}E" for v in vals) + "EEvv"


def _fake_build(cs, tmp_path, spills=None):
    """A stand-in for `_build`: a log per source with one entry a kernel
    instance (spilling 8 bytes where `spills` names it), and shared-memory
    entry points that return the sum of their arguments."""
    logs = {}
    for kernel, source, _, _, (_, values) in cs.HOPPER_KERNELS:
        for vals in values:
            spill = 8 if (kernel, vals) == spills else 0
            logs.setdefault(source, []).append(
                f"ptxas info    : Compiling entry function '{_mangled(kernel, vals)}' for 'sm_90a'\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
                f"ptxas info    : Used 128 registers, used 2 barriers\n")
    for source, entries in logs.items():
        (tmp_path / f"{source}.log").write_text("".join(entries))
    return types.SimpleNamespace(BUILD_DIR=tmp_path, INT=int,
                                 function=lambda name, argtypes: lambda *a: sum(a))


def test_hopper_kernel_report_reads_every_instance_with_its_parameters(tmp_path):
    cs = _chip_smoke()
    rows = cs.hopper_kernel_report(_fake_build(cs, tmp_path))
    walk = [r for r in rows if r["kernel"] == "ssd_bwd_walk_kernel"]
    grads = [r for r in rows if r["kernel"] == "ssd_bwd_grads_kernel"]
    assert sorted((r["P"], r["N"]) for r in walk) == sorted(
        (p, n) for p in (16, 32, 64) for n in (16, 32, 64, 128))
    assert len(grads) == 12 and all(r["threads"] == 512 for r in grads)
    # the shared memory entry point is called with the kind (0 walkers, 1
    # gradients) before P and N
    assert {r["dynamic_smem_bytes"] for r in grads if (r["P"], r["N"]) == (64, 128)} == {193}
    assert {r["dynamic_smem_bytes"] for r in walk if (r["P"], r["N"]) == (64, 128)} == {192}
    assert all(r["registers"] == 128 and r["spill_stores"] == 0 for r in rows)
    fwd = [r for r in rows if r["kernel"] == "flash_fwd_kernel"]
    assert [(r["D"], r["DV"]) for r in fwd] == [(32, 32), (64, 64), (80, 80), (128, 128),
                                               (192, 128)]
    # the shared memory entry point is called with the pair (D, DV)
    assert {r["dynamic_smem_bytes"] for r in fwd if r["D"] == 192} == {320}
    for r in rows:
        cs.check_no_spills(r)


@pytest.mark.parametrize("kernel,vals,fails", [
    ("ssd_bwd_grads_kernel", (64, 128), True),
    ("ssd_bwd_walk_kernel", (64, 128), True),
    ("ssd_bwd_walk_kernel", (32, 128), False),
    ("flash_bwd_dkv_kernel", (80, 80), True),
    ("flash_bwd_dkv_kernel", (128, 128), False),
    ("flash_fwd_kernel", (192, 128), True),
    ("flash_bwd_dq_kernel", (192, 128), True),
    ("flash_bwd_dkv_kernel", (192, 128), True),
    ("ssd_scan_kernel", (16,), True),           # jamba-1.5-large-398b's N 16
    ("ssd_scan_kernel", (32,), False),
    ("ssd_bwd_walk_kernel", (64, 16), True),    # jamba's P 64, N 16
    ("ssd_bwd_grads_kernel", (64, 16), True),
    ("ssd_bwd_grads_kernel", (32, 16), False),
])
def test_spill_gate_holds_the_instances_that_must_not_spill(tmp_path, kernel, vals, fails):
    cs = _chip_smoke()
    rows = cs.hopper_kernel_report(_fake_build(cs, tmp_path, spills=(kernel, vals)))
    spilling = [r for r in rows if r["spill_stores"]]
    assert len(spilling) == 1
    if fails:
        with pytest.raises(AssertionError, match="spills"):
            cs.check_no_spills(spilling[0])
    else:
        cs.check_no_spills(spilling[0])


def test_ssd_bwd_work_at_the_train_shape():
    """The bound's count at mamba2-130m's train shape (8 x 2048 tokens, 24
    heads, P 64, N 128), by hand: per (batch, head, chunk) the causal pairs
    T = 2080 times 2 P (dy u^T) + 3 P (att^T dy) + 2 N + 2 N (the
    E-weighted sums), and L P N = 524288 times 2 + 2 + 2 + 2 + 3; per
    (batch, chunk) C B^T, T N."""
    cs = _chip_smoke()
    nbytes, tc, f32 = cs.ssd_bwd_work(8, 2048, 24, 64, 128)
    macs = 8 * 24 * 32 * (2080 * (128 + 192 + 256 + 256) + 524288 * 11) + 8 * 32 * 2080 * 128
    assert tc == 2 * macs
    assert nbytes == 8 * 2048 * 24 * 64 * 8 + 4 * 8 * 2048 * 128 * 2 + 2 * 8 * 2048 * 24 * 4 + 2 * 24 * 4
    assert f32 == 2 * (8 * 24 * 32 * (2080 * (128 + 256) + 5 * 524288) + 8 * 32 * 2080 * 128)


def test_v3_small_config_keeps_the_full_head_dims_and_q_lora():
    cs = _chip_smoke()
    cfg = cs.v3_small_config()
    m = cfg.mla
    assert (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim, m.q_lora_rank) == (192, 128, 1536)
    assert cfg.mtp and cfg.moe.router == "sigmoid" and cfg.n_layers == 4
    assert cfg.moe.n_dense_prefix == 3 and cfg.d_model == 128


def test_moe_serve_launches_count_q_norm_where_the_config_has_it():
    """serve_v3's 4 layers run attn, q, kv and ffn norm a layer and
    final_norm, every one of 65 steps: 1,105 launches; deepseek-v2-lite-16b
    (no q-LoRA) 3 a layer: 5,330 at its 27."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cs = _chip_smoke()
    v3 = replace(get_config(cs.V3_ARCH), n_layers=cs.V3_SERVE_LAYERS)
    assert cs.moe_serve_launches(v3) == {"rmsnorm": 1105}
    assert cs.moe_serve_launches(get_config(cs.MOE_ARCH)) == {"rmsnorm": 5330}


def test_spill_gate_holds_the_rmsnorm_backward():
    cs = _chip_smoke()
    row = {"kernel": "rmsnorm_bwd_kernel", "source": "rmsnorm.cu", "registers": 128}
    cs.check_no_spills({**row, "spill_stores": 0, "spill_loads": 0})
    with pytest.raises(AssertionError, match="spills"):
        cs.check_no_spills({**row, "spill_stores": 8, "spill_loads": 8})


def test_upstream_of_keeps_earlier_layers_of_the_same_sequence_up_to_the_token():
    cs = _chip_smoke()
    flips = [{"layer": 0, "token": 5}, {"layer": 0, "token": 9}, {"layer": 0, "token": 12},
             {"layer": 1, "token": 15}, {"layer": 2, "token": 7}]
    # seq 10: token 7 is row 0, position 7; token 12 is row 1, position 2
    assert cs.upstream_of(flips[4], flips, 10) == [flips[0]]
    assert cs.upstream_of(flips[3], flips, 10) == [flips[2]]
    assert cs.upstream_of(flips[0], flips, 10) == []


def test_capacity_changes_finds_a_route_a_flip_pushed_past_capacity():
    """Two experts of capacity 2 (4 tokens, top-1, factor 1): token 0 moving
    to expert 1 drops token 3's route there, which selects the same expert
    in both runs; the flipped token itself is `route_flips`' to report."""
    import torch

    cs = _chip_smoke()
    cfg = types.SimpleNamespace(moe=types.SimpleNamespace(top_k=1, n_experts=2,
                                                          capacity_factor=1.0))
    a = [{"idx": torch.tensor([[0], [1], [0], [1]])}]
    b = [{"idx": torch.tensor([[1], [1], [0], [1]])}]
    assert cs.capacity_changes(a, b, cfg, 4) == [
        {"layer": 0, "token": 3, "kept_a": [1], "kept_b": []}]
    assert cs.capacity_changes(a, a, cfg, 4) == []


# ---------------------------------------------------------------------------
# decode attention's spill gate; the last four families' phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vals,spill", [((64, 1), 4), ((64, 1), 0), ((128, 2), 8),
                                        ((32, 1), 0)])
def test_spill_gate_fails_any_decode_kernel_instance_that_spills(tmp_path, vals, spill):
    """`ptxas_report` reads every decode_kernel<D, MT> instance with its
    template arguments, and `check_no_spills` fails any that spills: the
    row of the report as ptxas writes it for <64, 1> when it spilled (an
    8-byte stack frame, 4 bytes of spill stores and loads)."""
    cs = _chip_smoke()
    name = "_ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_95940b7213decode_kernel"
    (tmp_path / "decode_attention.cu.log").write_text(
        f"ptxas info    : Compiling entry function '{name}I" + "".join(f"Li{v}E" for v in vals)
        + "EEvNS_6ParamsE' for 'sm_90a'\n"
        f"    {2 * spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill "
        "loads\nptxas info    : Used 80 registers, used 1 barriers\n")
    (tmp_path / "rmsnorm.cu.log").write_text("")
    rows = cs.ptxas_report(types.SimpleNamespace(BUILD_DIR=tmp_path))
    assert rows == [{"kernel": "decode_kernel", "source": "decode_attention.cu",
                     "D": vals[0], "MT": vals[1], "stack": 2 * spill, "spill_stores": spill,
                     "spill_loads": spill, "registers": 80}]
    if spill:
        with pytest.raises(AssertionError, match=r"decode_kernel<%d, %d> spills" % vals):
            cs.check_no_spills(rows[0])
    else:
        cs.check_no_spills(rows[0])


def _spy_kernels(monkeypatch):
    """Counts each kernel wrapper's calls through the model's imports (a CPU
    tensor runs the plain version, which counts no launch)."""
    from repro_torch.kernels.cross_entropy import ops as ce_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import layers
    calls = {}

    def spy(mod, attr, names):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            for n in names:
                calls[n] = calls.get(n, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)
    spy(rms_ops, "rmsnorm", ["rmsnorm"])
    spy(rms_ops, "rmsnorm_bwd", ["rmsnorm_bwd"])
    spy(flash_ops, "flash_attention_fwd", ["flash_attention_fwd"])
    spy(flash_ops, "flash_attention_bwd", ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    spy(layers, "flash_attention_fwd", ["flash_attention_fwd"])
    spy(layers, "decode_attention", ["decode_attention"])
    spy(ce_ops, "fused_ce", ["fused_ce"])
    spy(ce_ops, "fused_ce_bwd", ["fused_ce_bwd"])
    spy(ssd_ops, "ssd_scan", ["ssd_scan"])
    spy(ssd_ops, "ssd_scan_bwd", ["ssd_scan_bwd"])
    return calls


@pytest.mark.parametrize("arch", ["command-r-35b", "starcoder2-15b", "pixtral-12b",
                                  "musicgen-large", "chatglm3-6b", "stablelm-3b"])
def test_dense_serve_and_train_launches_are_what_the_model_calls(monkeypatch, arch):
    """A reduced model's Server.generate (a prefill, then NEW decode steps;
    the stub frontend's embeds for pixtral and musicgen) and one train step
    (remat per layer, CE_CHUNKS chunks) call each kernel wrapper as often as
    `dense_serve_launches` and `dense_train_launches` count, the counts the
    serve and train phases gate on."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.models import init_model, loss_fn
    from repro_torch.runtime.steps import param_grads
    from repro_torch.tree import tree_leaves
    cs = _chip_smoke()
    srv = Server(arch, max_len=96, device="cpu", seed=1)
    cfg = srv.cfg
    calls = _spy_kernels(monkeypatch)
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 16))
    out = srv.generate(prompts, cs.NEW)
    assert out["finite"] and out["tokens"].shape == (2, cs.NEW)
    assert calls == cs.dense_serve_launches(cfg)
    calls.clear()
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 65)))
    loss, _ = loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg)
    param_grads(loss, leaves)
    assert calls == cs.dense_train_launches(cfg)


def test_dense_serve_bounds_at_full_width():
    """The four serve phases' configs at full width and full depth, built on
    the meta device as Server builds them: their parameter counts and the
    bounds each phase prints (4 x 512 prompt tokens, decode at the serve
    lengths): command-r-35b's tied 256000 x 8192 table is its head and is
    read by every decode step; the other three read every weight but their
    token table."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cs = _chip_smoke()
    want = {"command-r-35b": (30.284e9, 18.19, 117.4), "starcoder2-15b": (15.956e9, 9.40, 64.1),
            "pixtral-12b": (12.248e9, 7.02, 45.5), "musicgen-large": (2.4247e9, 1.70, 10.2)}
    assert [arch for _, arch, _ in cs.DENSE_SERVES] == list(want)
    for arch, (n, decode_ms, prefill_ms) in want.items():
        cfg = get_config(arch)
        params = init_model(cfg, torch.Generator(), "meta")
        bound = cs.dense_serve_bound(cfg, params, cs.BATCH, cs.PROMPT)
        assert abs(bound["params"] - n) <= 1e-3 * n
        assert bound["decode_step_bound_ms"] == pytest.approx(decode_ms, rel=1e-2)
        assert bound["prefill_bound_ms"] == pytest.approx(prefill_ms, rel=1e-2)
        assert bound["prefill_bound_by"] == "operations"
        tok = cfg.vocab_size * cfg.d_model * 2
        assert bound["weights_gb"] - bound["weights_read_gb"] == pytest.approx(
            0 if cfg.tie_embeddings else tok / 1e9)


def test_model_flops_count_a_tied_table_as_the_head():
    """train_command_r's 2 layers with the tied table: 6 x every param x
    tokens (the table is the head's matrix) plus the causal pairs; an
    untied model leaves its token table (a gather) out."""
    from dataclasses import replace
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    cr = replace(get_config(cs.CR_ARCH), n_layers=2)
    n = 3_506_520_064
    pairs = 8 * 64 * 512 * 513 // 2
    assert cs.model_flops(cr, n, 8, 512) == 6 * n * 4096 + 12 * 128 * pairs * 2
    sc = get_config(cs.SC_ARCH)
    assert cs.model_flops(sc, 10**9, 8, 512) == (6 * (10**9 - 49152 * 6144) * 4096
                                                  + 12 * 128 * (8 * 48 * 512 * 513 // 2) * 40)


def test_starcoder2_small_config_runs_rep_12_at_d_128():
    cs = _chip_smoke()
    cfg = cs.starcoder2_small_config()
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) == (12, 128)
    assert cfg.act == "gelu" and cfg.qkv_bias and cfg.norm == "layernorm"


# ---------------------------------------------------------------------------
# train_resume: the Trainer stopped and resumed over its BuffetFS data path
# ---------------------------------------------------------------------------

@pytest.fixture()
def one_thread():
    """One intra-op thread for 24 tiny train steps: the suite runs its files
    in parallel workers, where more threads only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [False, True])
def test_train_resume_counts_train_ssms_launches_and_fails_a_planted_leaf(monkeypatch,
                                                                         one_thread, fault):
    """`train_resume` on the CPU at the reduced size: each run calls the
    kernel wrappers `ssm_train_launches` times a step (train_ssm's counts),
    B resumes at the stop with A's state, C's batches and losses, and
    `resume_failures` finds nothing.  With one leaf of the restored state
    changed (one element of final_norm's scale), the checks name that leaf."""
    import torch
    from repro_torch.ckpt import manager
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config(cs.SSM_ARCH).reduced()
    # a train step's counts are train_ssm's, for any depth
    assert cs.ssm_train_launches(cfg)["ssd_scan"] == 2 * cfg.n_layers
    if fault:
        restore = manager.CheckpointManager.restore

        def planted(self, *a, **k):
            step, tree = restore(self, *a, **k)
            with torch.no_grad():
                tree["params"]["final_norm"]["scale"][0] += 1.0
            return step, tree
        monkeypatch.setattr(manager.CheckpointManager, "restore", planted)
    calls = _spy_kernels(monkeypatch)
    rec = cs.train_resume(torch.device("cpu"), reduced=True, batch=2, seq=64,
                          counter=(calls.clear, lambda: dict(calls)))
    failures = cs.resume_failures(rec, cs.ssm_train_launches(cfg))
    assert rec["runs"]["B"]["start_step"] == cs.RESUME_STOP
    assert [r["steps_run"] for r in rec["runs"].values()] == [8, 4, 12]
    assert rec["corpus"] == {"files": 128, "bytes_each": [12 + 65 * 4], "shard_dirs": 1}
    assert rec["runs"]["A"]["launches"] == {k: 8 * v for k, v in
                                            cs.ssm_train_launches(cfg).items()}
    # every run over the Trainer's own 4-server BuffetFS: RPCs counted, the
    # samples read with no open RPC, the checkpoints written and B's read
    for name, r in rec["runs"].items():
        bt = r["rpcs_by_type"]
        assert r["n_servers"] == 4 and r["critical_rpcs"] > 0 and r["async_rpcs"] > 0
        assert "OPEN_RECORD" not in bt and bt["READ"] >= 2 * r["steps_run"], (name, bt)
        assert bt["WRITE"] >= 134 * len(r["saves"]) and bt["CLOSE"] == r["async_rpcs"]
    assert "CREATE" in rec["runs"]["A"]["rpcs_by_type"]
    # the Trainer's servers nest a directory's or a file's lock around the
    # server lock, nothing else (no striping, no group table)
    assert all(r["lock_pairs"] == [("dir_mutex", "server_lock"), ("file_lock", "server_lock")]
               for r in rec["runs"].values())
    assert rec["runs"]["B"]["rpcs_by_type"]["READ"] > rec["runs"]["A"]["rpcs_by_type"]["READ"] / 2
    if not fault:
        assert failures == [] and rec["losses_bitwise"]
        assert [s["step"] for s in rec["runs"]["C"]["saves"]] == [4, 8, 12]
        # 11 param leaves in each of params, opt.m and opt.v (the blocks
        # stacked), opt.step; 133 part files and the MANIFEST
        assert all((s["leaves"], s["files"]) == (34, 134)
                   for r in rec["runs"].values() for s in r["saves"])
    else:
        assert rec["restored_diff_leaves"] == ["params.final_norm.scale"]
        assert any("params.final_norm.scale" in f for f in failures)


# ---------------------------------------------------------------------------
# train_sharded and compress: the phases on the CPU over a one-rank gloo
# group, and their failure checks on planted faults
# ---------------------------------------------------------------------------

@pytest.fixture()
def world_of_one(tmp_path):
    """A one-rank gloo process group for the test, destroyed after it."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_train_sharded_and_compress_run_on_a_one_rank_mesh(monkeypatch, one_thread,
                                                           world_of_one):
    """Reduced chatglm3-6b: the unsharded Trainer's 3 steps, then
    `train_sharded` from the same weights and batch on a 1 x 1 mesh (every
    loss and param leaf bitwise on the CPU, every leaf at its placements,
    `dense_train_launches` a step) and `compress` (every leaf bitwise the
    plain algebra and within half a quantization step; one step's launches)."""
    import itertools

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerConfig

    cs = _chip_smoke()
    cfg = get_config(cs.ARCH).reduced()
    b, s, steps = 2, 64, 3
    tc = TrainerConfig(arch=cs.ARCH, reduced=True, global_batch=b, seq_len=s, steps=steps,
                       log_every=steps, device="cpu", seed=cs.SEED,
                       moment_dtype=torch.bfloat16)
    tr = Trainer(tc, batches=itertools.repeat(cs.fixed_batch(cfg.vocab_size, b, s,
                                                             cs.SEED + 4)))
    out = tr.run()
    ref = {"losses": out["losses"], "params": cs.host_copy(tr.state["params"])}
    calls = _spy_kernels(monkeypatch)
    counter = (calls.clear, lambda: dict(calls))
    rec = cs.train_sharded(torch.device("cpu"), ref, reduced=True, batch=b, seq=s, steps=steps,
                           counter=counter)
    per_step = cs.dense_train_launches(cfg)
    assert cs.sharded_failures(rec, per_step) == []
    assert rec["losses_bitwise"] and rec["params_bitwise"]
    assert rec["mesh"] == {"data": 1, "model": 1}
    rec = cs.compress(torch.device("cpu"), reduced=True, batch=b, seq=s, counter=counter)
    assert cs.compress_failures(rec, per_step) == []
    assert rec["compressed_all_reduce_bytes"] > 2 * rec["bf16_all_reduce_bytes"]


def _sharded_record(per_step, steps=2):
    return {"steps": steps, "steps_run": steps, "losses": [6.0, 5.5],
            "ref_losses": [6.0, 5.5], "loss_rel_err": [0.0, 0.0],
            "param_rel_l2": {"embed.tok": 0.0, "final_norm.scale": 0.0},
            "placement_faults": [],
            "launches": {"ssd_scan": 0, **{k: v * steps for k, v in per_step.items()}}}


@pytest.mark.parametrize("fault", [None, "loss", "placement", "launch", "param"])
def test_sharded_failures_name_each_planted_fault(fault):
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    per_step = cs.dense_train_launches(get_config(cs.ARCH))
    rec = _sharded_record(per_step)
    if fault == "loss":          # just past 1e-5 relative
        rec["losses"][1] = 5.5 * (1 + 1.5e-5)
        rec["loss_rel_err"][1] = 1.5e-5
    elif fault == "placement":
        rec["placement_faults"] = ["params.blocks.0.attn.wq"]
    elif fault == "launch":      # one launch missing
        rec["launches"]["flash_attention_bwd_dq"] -= 1
    elif fault == "param":
        rec["param_rel_l2"]["embed.tok"] = 2e-3
    failures = cs.sharded_failures(rec, per_step)
    if fault is None:
        assert failures == []
    else:
        assert len(failures) == 1, failures
        assert {"loss": "losses differ", "placement": "params.blocks.0.attn.wq",
                "launch": "launches", "param": "embed.tok"}[fault] in failures[0]


@pytest.mark.parametrize("fault", [None, "ulp", "dtype"])
def test_compress_checks_fail_a_leaf_one_ulp_off(fault):
    """The compressed leaves against plain `_dequantize(_quantize(g))`: one
    element of one leaf one bf16 ulp off (or the leaf in another dtype) is
    named; the unperturbed leaves pass, each within half a step."""
    import torch
    from repro_torch.runtime.compression import _dequantize, _quantize
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(300, generator=g).to(torch.bfloat16),
             torch.randn(4, 256, generator=g) * 1e-3, torch.zeros(7)]
    outs = [_dequantize(*_quantize(x), x.shape, x.dtype) for x in grads]
    if fault == "ulp":               # the next bf16 value away from zero, by its bits
        outs[0].view(torch.int16)[5] += 1
    elif fault == "dtype":
        outs[1] = outs[1].double()
    errs = cs.compress_leaf_errors(["a", "b", "c"], grads, outs)
    rec = {"identity_at_size_1": True, "launches": {"fused_ce": 1}, **errs}
    failures = cs.compress_failures(rec, {"fused_ce": 1})
    if fault is None:
        assert failures == [] and errs["over_bound"] == {}
    else:
        assert errs["not_bitwise"] == (["a"] if fault == "ulp" else ["b"])
        assert len(failures) >= 1



# ---------------------------------------------------------------------------
# train_sharded_ssm, train_sharded_moe, serve_sharded_ssm, serve_sharded_moe
# and dryrun_ssm at the reduced size, over a one-rank gloo group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "deepseek-v2-lite-16b"])
def test_train_sharded_runs_the_ssm_and_moe_families_on_a_one_rank_mesh(monkeypatch, one_thread,
                                                                        world_of_one, arch):
    """The unsharded Trainer's 2 steps of reduced mamba2-130m (train_ssm's
    counts) or deepseek-v2-lite-16b (train_moe's), every route recorded,
    then `train_sharded` from the same weights and batch on a 1 x 1 mesh:
    every loss and param leaf bitwise on the CPU, the same launches a step,
    the same routes call by call."""
    import itertools

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.models import layers

    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    b, s, steps = 2, 64, 2
    tc = TrainerConfig(arch=arch, reduced=True, global_batch=b, seq_len=s, steps=steps,
                       log_every=steps, device="cpu", seed=cs.SEED, moment_dtype=torch.float32)
    tr = Trainer(tc, batches=itertools.repeat(cs.fixed_batch(cfg.vocab_size, b, s, cs.SEED + 4)))
    with cs.RouteRecorder(layers) as recorder:
        out = tr.run()
    ref = {"losses": out["losses"], "params": cs.host_copy(tr.state["params"])}
    unsharded_routes = recorder.take()
    calls = _spy_kernels(monkeypatch)
    with cs.RouteRecorder(layers) as recorder:
        rec = cs.train_sharded(torch.device("cpu"), ref, arch=arch, reduced=True, batch=b, seq=s,
                               steps=steps, moment_dtype=torch.float32,
                               counter=(calls.clear, lambda: dict(calls)))
    per_step = (cs.ssm_train_launches(cfg) if cfg.family == "ssm"
                else cs.moe_train_launches(cfg, s))
    assert cs.sharded_failures(rec, per_step) == []
    assert rec["losses_bitwise"] and rec["params_bitwise"]
    routes = recorder.take()
    assert len(routes) == len(unsharded_routes) == 2 * steps * cs.moe_layer_count(cfg)
    assert cs.route_flips(unsharded_routes, routes) == []


@pytest.mark.parametrize("arch", ["mamba2-130m", "deepseek-v2-lite-16b"])
def test_serve_sharded_runs_the_ssm_and_moe_families_on_a_one_rank_mesh(monkeypatch,
                                                                        world_of_one, arch):
    """Reduced mamba2-130m and deepseek-v2-lite-16b, 8 new tokens: Server.generate,
    then `serve_sharded` with the same weights and prompts on a 1 x 1 mesh:
    the same tokens, the last logits bitwise on the CPU, the same launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server

    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    prompt, max_len, new = 16, 40, 8
    srv = Server(arch, max_len=max_len, device="cpu", seed=cs.SEED)
    prompts = np.random.default_rng(cs.SEED + 1).integers(
        1, cfg.vocab_size, size=(cs.BATCH, prompt + 1)).astype(np.int32)[:, :prompt]
    calls = _spy_kernels(monkeypatch)
    out = srv.generate(prompts, new)
    want = dict(calls)
    ref = {"tokens": out["tokens"], "last_logits": out["last_logits"].float()}
    rec = cs.serve_sharded(torch.device("cpu"), ref, arch=arch, reduced=True, prompt=prompt,
                           max_len=max_len, new=new, counter=(calls.clear, lambda: dict(calls)))
    assert cs.sharded_serve_failures(rec, want) == []
    assert rec["tokens_equal"] and rec["logits_bitwise"] and want["rmsnorm"] > 0


def test_dryrun_ssm_cell_holds_train_ssms_bytes_calls_and_flops():
    """`dryrun_ssm_cell` at the reduced size on the CPU: the 1 x 1 train
    cell's argument bytes equal a real state's (fp32 moments) and batch's,
    its kernel calls `ssm_train_launches`, its FLOPs within
    TOL_DRYRUN_FLOPS of `ssm_train_flops` (what the card's run gates)."""
    import itertools

    import torch
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves
    cs = _chip_smoke()
    b, s = 2, 256
    tc = TrainerConfig(arch=cs.SSM_ARCH, reduced=True, global_batch=b, seq_len=s,
                       device="cpu", seed=cs.SEED, moment_dtype=torch.float32)
    fixed = cs.fixed_batch(512, b, s, cs.SEED + 15)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    tr.init_state()
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(tr.state) + list(tr._to_device(fixed).values()))
    rec = cs.dryrun_ssm_cell(torch.device("cpu"), {"argument_bytes": arg_bytes,
                                                   "peak_bytes": 1}, reduced=True, batch=b, seq=s)
    rec["peak_rel_err"] = 0.0                   # no allocator to read here
    print({k: v for k, v in rec.items() if k != "cells"})
    assert cs.dryrun_failures(rec) == []
    assert rec["train_argument_bytes"] == arg_bytes

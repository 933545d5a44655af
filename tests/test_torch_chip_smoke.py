"""`chip_smoke.py`'s bookkeeping that needs no card: the kernel resource
report read from `ptxas -v` logs, its spill gate, and the SSD backward's
count of work.  The logs here are written by the test in ptxas's format."""
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


@pytest.mark.parametrize("arch,seq,row1_len", [
    ("chatglm3-6b", 64, 40), ("mamba2-130m", 192, 40),
    ("deepseek-v2-lite-16b", 192, 152),
    ("deepseek-v3-671b", 192, 152)])           # as chip_smoke.py's four checks run
def test_train_check_holds_each_family_by_one_rule(arch, seq, row1_len):
    """`train_check` with the CPU on both sides: the same plain versions give
    the same loss and gradients and no routing flip, pinned or unpinned; an
    MoE model's route calls (the forward's and the remat recompute's) are
    recorded, one per MoE layer each, and a model without MoE makes none.
    deepseek-v3-671b's sigmoid router gets a nonzero router_bias, whose
    gradient is exactly zero on every side (and gated so)."""
    import torch

    cs = _chip_smoke()
    from repro_torch.configs import get_config
    small = {cs.MOE_ARCH: cs.moe_small_config, cs.V3_ARCH: cs.v3_small_config}
    cfg = small[arch]() if arch in small else get_config(arch).reduced()
    rec = cs.train_check(torch.device("cpu"), cfg, 3, seq, row1_len)
    assert rec["ok"] and rec["rel_err_loss"] <= 1e-6 and rec["rel_l2_all_grads"] <= 1e-6
    assert rec["route_flips"] == 0 and rec["unpinned_forward"]["route_flips"] == 0
    n_moe = cfg.n_layers - cfg.moe.n_dense_prefix if cfg.moe else 0
    assert rec["moe_route_calls"] == 2 * n_moe
    assert rec["routes"] == 2 * n_moe * 2 * seq * (cfg.moe.top_k if cfg.moe else 0)
    sigmoid = cfg.moe is not None and cfg.moe.router == "sigmoid"
    assert list(rec["zero_grad_leaves_max_abs"]) == (["blocks.0.ffn.router_bias"] if sigmoid
                                                     else [])
    assert all(v == 0.0 for z in rec["zero_grad_leaves_max_abs"].values() for v in z.values())


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

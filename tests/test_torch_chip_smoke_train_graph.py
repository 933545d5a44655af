"""`chip_smoke.py`'s checks of the Trainer's train graph, on the CPU.

On the card every unsharded train phase runs the Trainer through its CUDA
graph and then the same run as a plain eager loop of `train_step`
(`eager_train`), and holds the two bitwise (`graph_vs_eager`); the graph's
DOT dump is read by `graph_kernel_nodes` and gated by
`train_graph_failures`.  Here: the eager reference against the Trainer on
the CPU (which runs the same step eagerly), the comparison on planted
differences, and the gate on a dump written in CUDA's format.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import itertools
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(scope="module")
def runs():
    """Reduced chatglm3-6b, 3 steps of 2 x 64 on one fixed batch, bf16
    moments: the Trainer's run and `eager_train`'s from the same config."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerConfig

    cfg = get_config(CS.ARCH).reduced()
    fixed = CS.fixed_batch(cfg.vocab_size, 2, 64, CS.SEED + 4)
    tc = TrainerConfig(arch=CS.ARCH, global_batch=2, seq_len=64, steps=3, log_every=3,
                       device="cpu", seed=CS.SEED, moment_dtype=torch.bfloat16)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    out = tr.run()
    trainer = {"losses": out["losses"], "params": CS.host_copy(tr.state["params"]),
               "capture_s": out["capture_s"]}
    return trainer, CS.eager_train("cpu", tc, [fixed] * 3)


def test_eager_train_is_the_trainer_on_the_cpu_bitwise(runs):
    """On the CPU the Trainer runs the eager step: `eager_train` gives its
    losses and final params bit for bit, and `graph_vs_eager` holds them
    bitwise (no second run needed)."""
    trainer, eager = runs
    assert trainer["capture_s"] == 0.0 and len(eager["losses"]) == 3
    assert eager["step_ms"] > 0 and len(eager["step_times_ms"]) == 3
    rec = CS.graph_vs_eager(trainer, eager)
    assert rec["ok"] and rec["bitwise"] and rec["held_to"] == "bitwise"
    assert rec["graph"]["differing_leaves"] == {} and rec["graph"]["steps"] == (3, 3)
    assert "eager_again" not in rec


def _planted(run, leaf=None, step=None):
    """A copy of `run` with one element of `leaf` one bf16 ulp up, or the
    loss at `step` (1-based) moved by 1e-7 of itself."""
    params = dict(run["params"])
    if leaf is not None:
        t = params[leaf].clone()
        t.view(torch.int16).view(-1)[0] += 1        # the next bf16 value
        params[leaf] = t
    losses = list(run["losses"])
    if step is not None:
        losses[step - 1] *= 1 + 1e-7
    return {**run, "params": params, "losses": losses}


def test_graph_vs_eager_names_a_leaf_and_a_step_that_differ(runs):
    """A graphed run one element off in one leaf, or one loss off, is not
    bitwise: with no second eager run it fails, naming the leaf and the
    step; with a second eager run that repeats the first it still fails
    (the graph changed bits)."""
    trainer, eager = runs
    leaf = "final_norm.scale"
    for got in (_planted(trainer, leaf=leaf), _planted(trainer, step=2)):
        rec = CS.graph_vs_eager(got, eager)
        assert not rec["ok"] and not rec["bitwise"]
        again = CS.graph_vs_eager(got, eager, eager)
        assert not again["ok"] and again["eager_repeatable"] and again["held_to"] == "bitwise"
    assert list(CS.graph_vs_eager(_planted(trainer, leaf=leaf), eager)["graph"]
                ["differing_leaves"]) == [leaf]
    assert CS.graph_vs_eager(_planted(trainer, step=2), eager)["graph"][
        "first_loss_step_differing"] == 2


def test_graph_vs_eager_takes_the_sharded_bounds_where_the_eager_step_does_not_repeat(runs):
    """Where two eager runs differ, the graphed run is held to
    train_sharded's bounds: one bf16 ulp in a leaf and a loss 1e-7 off
    pass; a leaf moved past TOL_SHARDED_PARAM fails."""
    trainer, eager = runs
    leaf = "final_norm.scale"
    jitter = _planted(eager, leaf="embed.tok")
    rec = CS.graph_vs_eager(_planted(trainer, leaf=leaf, step=3), eager, jitter)
    assert rec["ok"] and not rec["bitwise"] and not rec["eager_repeatable"]
    assert "train_sharded" in rec["held_to"]
    assert list(rec["eager_again"]["differing_leaves"]) == ["embed.tok"]
    far = dict(trainer["params"])
    far[leaf] = far[leaf] * 2
    assert not CS.graph_vs_eager({**trainer, "params": far}, eager, jitter)["ok"]


# a train graph's DOT dump in CUDA's format (`cudaGraphDebugDotPrint`, as
# `CUDAGraph.debug_dump` writes it): an RMSNorm backward node launched
# cooperatively, a flash forward, a cuBLAS product, a copy and a memset
def _node(i, name, coop=0):
    return (f'"graph_1_node_{i}"[style="bold" shape="record" label="{{KERNEL\n'
            f'| {{ID | {i} (topoId: {i}) | {name}\\<\\<\\<132,512,0\\>\\>\\>}}\n'
            f'| {{cooperative | {coop}}}\n}}"];\n')


def _dot(coop=1, copy="DtoD (DEVICE to DEVICE)"):
    return ("digraph dot {\nsubgraph cluster_1 {\n"
            + _node(1, "_ZN12_GLOBAL__N_118rmsnorm_bwd_kernelILi2EEEvPK13__nv_bfloat16", coop)
            + _node(2, "_ZN12_GLOBAL__N_116flash_fwd_kernelILi128ELi128EEEvNS_6ParamsE")
            + _node(3, "nvjet_tst_128x64_64x4_1x2_h_bz_TNT")
            + '"graph_1_node_4"[style="bold" shape="record" label="{\nMEMCPY\n'
            + '| {{ID | node handle} | {4 (topoId: 4) | 0x1}}\n'
            + f'| {{kind | {copy}}}\n}}"];\n'
            + '"graph_1_node_5"[style="bold" shape="record" label="{\nMEMSET\n'
            + '| {{ID | node handle} | {5 (topoId: 5) | 0x2}}\n}"];\n'
            + '"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];\n}\n}\n')


def _record(dot, barrier=(0, 7)):
    nodes = CS.graph_kernel_nodes(dot)
    nodes["distinct_kernels"] = len(nodes.pop("by_name"))
    return {"nodes": nodes, "step_launches": {"rmsnorm_bwd": 1, "flash_attention_fwd": 1},
            "rmsnorm_bwd_barrier": list(barrier)}


PER_STEP = {"rmsnorm_bwd": 1, "flash_attention_fwd": 1, "fused_ce": 0}


def test_graph_kernel_nodes_reads_the_cooperative_launches():
    got = CS.graph_kernel_nodes(_dot())
    assert got["cooperative"] == {"rmsnorm_bwd": 1}
    assert got["by_wrapper"] == {"rmsnorm_bwd": 1, "flash_attention_fwd": 1}
    assert got["kernel_nodes"] == 3 and got["memcpy_nodes"] == {"DtoD": 1}
    assert CS.graph_kernel_nodes(_dot(coop=0))["cooperative"] == {}


def test_train_graph_failures_pass_a_good_graph_and_name_each_fault():
    assert CS.train_graph_failures(_record(_dot()), PER_STEP) == []
    faults = {
        "hand-written kernel nodes": _record(_dot().replace("flash_fwd_kernel",
                                                            "flash_fwd_other")),
        "device to device": _record(_dot(copy="HtoD (HOST to DEVICE)")),
        "cooperative": _record(_dot(coop=0)),
        "grid barrier": _record(_dot(), barrier=(3, 7)),
    }
    for what, rec in faults.items():
        failures = CS.train_graph_failures(rec, PER_STEP)
        assert len(failures) >= 1 and any(what in f for f in failures), (what, failures)
    rec = _record(_dot())
    rec["step_launches"] = {"rmsnorm_bwd": 2, "flash_attention_fwd": 1}
    assert any("a replay counts" in f for f in CS.train_graph_failures(rec, PER_STEP))

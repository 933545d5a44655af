"""The compiled train step on the CPU: what a CUDA graph of it needs.

JAX's Trainer jits `train_step` once, the state donated.  The port's
counterpart is one CUDA graph of the whole step (the loss's forward,
autograd's backward, AdamW), captured after an eager warm-up step and
replayed for every later step (`launch/train.py`).  A graph replays fixed
addresses and reads nothing back to the host, so the step may not read a
value on the host, copy host data to the card, or hand back a state leaf
that is a new tensor (the next replay would read the captured one).  The
CPU cannot capture a graph; these tests hold what a capture needs, on seven
reduced configs (chatglm3-6b, stablelm-3b, mamba2-130m,
deepseek-v2-lite-16b, deepseek-v3-671b with its MTP head, musicgen-large
and chip_smoke.py's `hybrid_small_config`):

* `train_step` traced on "meta" tensors (no values: a host read fails the
  trace) under `tests/_torch_host_traffic.py`'s `HostTraffic` finishes, and
  records no host read, no op whose output size depends on data, no tensor
  made from host data and no op that takes a CPU tensor into a "meta" one;
* every leaf of the state that comes out (each param, `m`, `v` and the step
  counter) is the tensor that went in;

and that the Trainer on the CPU takes the eager path as it did: no graph,
capture_s 0, its losses those of a plain `train_step` loop bit for bit.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import itertools
from pathlib import Path

import pytest
import torch
from _torch_host_traffic import HostTraffic

from repro_torch.configs import InputShape, get_config
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime.steps import abstract_batch, abstract_params, train_step
from repro_torch.tree import tree_leaves, tree_map

B, S = 2, 64
CONFIGS = ["chatglm3-6b", "stablelm-3b", "mamba2-130m", "deepseek-v2-lite-16b",
           "deepseek-v3-671b", "musicgen-large", "hybrid_small"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(name):
    return (_chip_smoke().hybrid_small_config() if name == "hybrid_small"
            else get_config(name).reduced())


def _meta(t, grad=False):
    return torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_reads_nothing_on_the_host_and_keeps_every_state_leaf(name):
    """The step on "meta" tensors, on the batch the Trainer feeds (tokens,
    labels, loss_mask): no host op, no host-to-device copy, the state's
    leaves the same objects after the step, the metrics 0-d tensors with no
    values."""
    cfg = _config(name)
    assert name != "deepseek-v3-671b" or cfg.mtp
    params = tree_map(lambda t: _meta(t, True), abstract_params(cfg, "cpu"))
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=8)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    batch = abstract_batch(cfg, InputShape("train", S, B, "train"), device="cpu")
    batch = {k: _meta(batch[k]) for k in ("tokens", "labels", "loss_mask")}
    leaves = tree_leaves(state)
    log = HostTraffic()
    with log:
        new_state, metrics = train_step(state, batch, cfg, opt_cfg)
    assert not log.host_ops(), log.host_ops()
    assert not log.to_device, log.to_device
    after = tree_leaves(new_state)
    assert len(after) == len(leaves) and all(a is b for a, b in zip(after, leaves))
    want = {"loss", "lr", "grad_norm"} | ({"mtp_ce"} if cfg.mtp else set())
    assert want <= metrics.keys()
    assert all(metrics[k].is_meta and metrics[k].shape == () for k in want)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-130m"])
def test_trainer_on_the_cpu_takes_the_eager_step_unchanged(arch):
    """The Trainer on the CPU: no train graph, capture_s 0, and every loss
    and final param bitwise a plain loop of `train_step` from the same seed
    on the same batch; a second `run(until=...)` goes on from there."""
    cfg = get_config(arch).reduced()
    fixed = _chip_smoke().fixed_batch(cfg.vocab_size, B, S, 3)
    tc = TrainerConfig(arch=arch, steps=4, global_batch=B, seq_len=S, log_every=4,
                       device="cpu", seed=1)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    out = tr.run(until=2)
    tr.start_step = 2
    more = tr.run()
    assert out["capture_s"] == more["capture_s"] == 0.0 and tr.train_graph() is None
    assert len(out["step_times_s"]) == 2 and len(more["step_times_s"]) == 2

    ref = Trainer(tc, batches=[])
    ref.init_state()
    state, batch, losses = ref.state, ref._to_device(fixed), []
    for _ in range(4):
        state, metrics = train_step(state, batch, ref.cfg, ref.opt_cfg)
        losses.append(float(metrics["loss"]))
    assert out["losses"] + more["losses"] == losses
    for a, b in zip(tree_leaves(tr.state), tree_leaves(state)):
        assert torch.equal(a, b)

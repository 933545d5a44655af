"""`chip_smoke.py`'s `train_check` on the CPU: the gate of the reduced train
checks (train_check, train_check_ssm, train_check_moe, train_check_v3,
train_check_hybrid's whole-model reading) held with the CPU on both sides.
Its own file, apart from `tests/test_torch_chip_smoke.py`: its five cases
take most of that file's time, and a file runs on one worker."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,seq,row1_len", [
    ("chatglm3-6b", 64, 40), ("mamba2-130m", 192, 40),
    ("deepseek-v2-lite-16b", 192, 152),
    ("deepseek-v3-671b", 192, 152),
    ("jamba-1.5-large-398b", 192, 152)])       # as chip_smoke.py's five checks run
def test_train_check_holds_each_family_by_one_rule(arch, seq, row1_len):
    """`train_check` with the CPU on both sides: the same plain versions give
    the same loss and gradients and no routing flip, pinned or unpinned; an
    MoE model's route calls (the forward's and the remat recompute's) are
    recorded, one per MoE layer each (a hybrid model's four a period block),
    and a model without MoE makes none.  deepseek-v3-671b's sigmoid router
    gets a nonzero router_bias, whose gradient is exactly zero on every side
    (and gated so)."""
    import torch

    cs = _chip_smoke()
    from repro_torch.configs import get_config
    small = {cs.MOE_ARCH: cs.moe_small_config, cs.V3_ARCH: cs.v3_small_config,
             cs.HYBRID_ARCH: cs.hybrid_small_config}
    cfg = small[arch]() if arch in small else get_config(arch).reduced()
    rec = cs.train_check(torch.device("cpu"), cfg, 3, seq, row1_len)
    assert rec["ok"] and rec["rel_err_loss"] <= 1e-6 and rec["rel_l2_all_grads"] <= 1e-6
    assert rec["route_flips"] == 0 and rec["unpinned_forward"]["route_flips"] == 0
    n_moe = cs.moe_layer_count(cfg)
    assert n_moe == {"deepseek-v2-lite-16b": 3, "deepseek-v3-671b": 1,
                     "jamba-1.5-large-398b": 4}.get(arch, 0)
    assert rec["moe_route_calls"] == 2 * n_moe
    assert rec["routes"] == 2 * n_moe * 2 * seq * (cfg.moe.top_k if cfg.moe else 0)
    sigmoid = cfg.moe is not None and cfg.moe.router == "sigmoid"
    assert list(rec["zero_grad_leaves_max_abs"]) == (["blocks.0.ffn.router_bias"] if sigmoid
                                                     else [])
    assert all(v == 0.0 for z in rec["zero_grad_leaves_max_abs"].values() for v in z.values())

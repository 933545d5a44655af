"""`chip_smoke.py`'s train_sharded_resume phase on the CPU, at the reduced
size over a one-rank gloo group, and `sharded_resume_failures` on planted
faults.  Its own file, apart from tests/test_torch_chip_smoke.py: a file
runs on one worker."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import itertools

import numpy as np
import pytest

from test_torch_chip_smoke import _spy_kernels
from test_torch_chip_smoke_sharded_hybrid import _chip_smoke, world_of_one  # noqa: F401


@pytest.mark.parametrize("fault", [False, True])
def test_train_sharded_resume_is_bitwise_train_sharded_on_a_one_rank_mesh(monkeypatch,
                                                                         world_of_one, fault):
    """Reduced mamba2-130m, fp32 moments: the unsharded Trainer's 4 steps,
    `train_sharded` of the same (its losses and final params kept), then
    `train_sharded_resume` stopped after step 2: every check passes (the
    restored state, the MANIFEST, the plain restore, the losses and final
    params bitwise; `ssm_train_launches` a step), the save gathered every
    leaf and wrote 34 leaves in 134 files.  With one element of the
    restored final_norm scale changed, the checks name that leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.runtime import elastic

    if fault:
        restore = elastic.elastic_restore

        def planted(*a, **k):
            res = restore(*a, **k)
            with torch.no_grad():
                res.state["params"]["final_norm"]["scale"].to_local()[0] += 1.0
            return res
        monkeypatch.setattr(elastic, "elastic_restore", planted)

    cs = _chip_smoke()
    cfg = get_config(cs.SSM_ARCH).reduced()
    b, s, steps, stop = 2, 64, 4, 2
    tc = TrainerConfig(arch=cs.SSM_ARCH, reduced=True, global_batch=b, seq_len=s, steps=steps,
                       log_every=steps, device="cpu", seed=cs.SEED, moment_dtype=torch.float32)
    fixed = cs.fixed_batch(cfg.vocab_size, b, s, cs.SEED + 15)
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    out = tr.run()
    unsharded = {"losses": out["losses"], "params": cs.host_copy(tr.state["params"])}
    calls = _spy_kernels(monkeypatch)
    counter = (calls.clear, lambda: dict(calls))
    kept = {}
    rec = cs.train_sharded(torch.device("cpu"), unsharded, arch=cs.SSM_ARCH, reduced=True,
                           batch=b, seq=s, steps=steps, moment_dtype=torch.float32,
                           batch_seed=cs.SEED + 15, counter=counter, keep=kept)
    assert rec["losses_bitwise"] and rec["params_bitwise"]
    assert kept["losses"] == unsharded["losses"] and kept["peak_mem_gb"] is None
    rec = cs.train_sharded_resume(torch.device("cpu"), kept, reduced=True, batch=b, seq=s,
                                  steps=steps, stop=stop, counter=counter)
    per_step = cs.ssm_train_launches(cfg)
    failures = cs.sharded_resume_failures(rec, per_step)
    if fault:
        assert rec["restored_diff_leaves"] == ["params.final_norm.scale"]
        assert any("params.final_norm.scale" in f for f in failures)
        assert not rec["losses_bitwise"] and rec["param_diff_leaves"]
        return
    assert failures == []
    assert rec["losses_bitwise"] and rec["restored_step"] == rec["sampler_step"] == stop
    assert rec["launches"]["A"] == {k: stop * v for k, v in per_step.items()}
    params = unsharded["params"].values()
    assert rec["state_leaves"] == 3 * len(params) + 1
    save = rec["save"]
    assert not save["block"] and (save["leaves"], save["files"]) == (34, 134)
    # every param and both fp32 moments gathered whole; opt.step is plain
    assert save["gathered_bytes"] == sum(t.numel() * (t.element_size() + 8) for t in params)
    assert save["gather_s"] >= 0 and save["copy_s"] > 0 and save["write_s"] > 0
    # the checkpoints went over the port's BuffetFS: RPCs counted, no open RPC
    rpcs = rec["rpcs"]
    assert rpcs["critical"] > 0 and rpcs["async"] == rpcs["by_type"]["CLOSE"]
    assert "OPEN_RECORD" not in rpcs["by_type"] and rpcs["by_type"]["WRITE"] >= 2 * 134


def _record(per_step, stop=4, steps=8):
    losses = [10.5, 10.25, 10.0, 9.75, 9.5, 9.25, 9.0, 8.75]
    return {"stop": stop, "steps": steps, "restored_step": stop, "sampler_step": stop,
            "ref_losses": list(losses), "a_losses": losses[:stop], "b_losses": losses[stop:],
            "restored_diff_leaves": [], "placement_faults": [], "manifest_diffs": [],
            "plain_restored_diff_leaves": [], "param_diff_leaves": [],
            "launches": {r: {"flash_attention_fwd": 0, **{k: v * n for k, v in per_step.items()}}
                         for r, n in (("A", stop), ("B", steps - stop))},
            "peak_mem_gb": 11.0, "ref_peak_mem_gb": 10.9, "largest_leaf_gb": 0.154}


@pytest.mark.parametrize("fault", [None, "leaf", "crc", "ulp", "peak", "launch", "step"])
def test_sharded_resume_failures_name_each_planted_fault(fault):
    """A restored leaf not bitwise, a crc differing from the plain save's, a
    resumed loss one fp32 ulp off, the peak past train_sharded's plus the
    largest leaf plus 1 %, a launch missing, the restore at another step:
    each fails the record, alone."""
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    per_step = cs.ssm_train_launches(get_config(cs.SSM_ARCH))
    rec = _record(per_step)
    if fault == "leaf":
        rec["restored_diff_leaves"] = ["opt.m.blocks.3.in_proj"]
    elif fault == "crc":
        rec["manifest_diffs"] = ["params.embed.tok"]
    elif fault == "ulp":
        x = np.float32(rec["b_losses"][1])
        rec["b_losses"][1] = float(np.nextafter(x, np.float32(np.inf)))
    elif fault == "peak":       # just past (10.9 + 0.154) x 1.01
        rec["peak_mem_gb"] = (10.9 + 0.154) * 1.01 + 1e-6
    elif fault == "launch":
        rec["launches"]["B"]["ssd_scan_bwd"] -= 1
    elif fault == "step":
        rec["sampler_step"] = 5
    failures = cs.sharded_resume_failures(rec, per_step)
    if fault is None:
        assert failures == []
    else:
        assert len(failures) == 1, failures
        assert {"leaf": "opt.m.blocks.3.in_proj", "crc": "params.embed.tok",
                "ulp": "resumed losses", "peak": "peak", "launch": "run B's launches",
                "step": "sampler at 5"}[fault] in failures[0]

"""`chip_smoke.py`'s hybrid (jamba-1.5-large-398b) phases on the CPU: the
serve_hybrid cut and its launch counts, train_check_hybrid's config, and
`hybrid_train_check`, unit by unit, with and without a planted fault.  Its
own file, apart from `tests/test_torch_chip_smoke.py`: a file runs on one
worker, and these take a third of that file's time."""
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


def test_hybrid_serve_launches_per_run():
    """serve_hybrid's one period block, per forward: mixer_norm and ffn_norm
    of 8 layers, the 7 Mamba layers' gated out_norm and final_norm, 24
    RMSNorm launches, 65 forwards (the prefill and 64 decode steps): 1,560;
    the prefill's one flash forward and 7 SSD scans; one decode attention a
    step.  Two blocks double every count but final_norm's."""
    from dataclasses import replace

    cs = _chip_smoke()
    cfg = cs.hybrid_serve_config()
    assert cs.NEW == 64
    assert cs.hybrid_serve_launches(cfg) == {"rmsnorm": 1560, "flash_attention_fwd": 1,
                                             "ssd_scan": 7, "decode_attention": 64}
    assert cs.hybrid_serve_launches(replace(cfg, n_layers=16)) == {
        "rmsnorm": 47 * 65, "flash_attention_fwd": 2, "ssd_scan": 14, "decode_attention": 128}


def test_serve_hybrid_cut_keeps_every_width_and_holds_25_8_b_params():
    """The serve_hybrid cut: one of the 9 period blocks and 8 of the 16
    experts, every width of the full config kept; ~25.8 B params (51.6 GB
    in bf16) as `init_model` makes them (on the meta device), the count
    serve_hybrid's bound reads off the built params."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.tree import tree_leaves
    cs = _chip_smoke()
    full, cfg = get_config(cs.HYBRID_ARCH), cs.hybrid_serve_config()
    assert cfg == replace(full, n_layers=8, moe=replace(full.moe, n_experts=8))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (8192, 64, 8, 128)
    assert (cfg.d_ff, cfg.moe.d_expert_ff, cfg.moe.top_k, cfg.vocab_size) == (
        24576, 24576, 2, 65536)
    assert (cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.expand) == (64, 16, 2)
    assert [c.split(":")[0] for c in cs.HYBRID_SERVE_CUT] == [
        "n_layers 8 of 72", "n_experts 8 of 16 (top-2 kept)"]
    params = init_model(cfg, torch.Generator(), "meta")
    total = sum(t.numel() for t in tree_leaves(params))
    assert abs(total - 25.8e9) <= 0.01 * 25.8e9
    bound = cs.hybrid_serve_bound(cfg, params, cs.BATCH, cs.PROMPT)
    assert bound["params"] == total and abs(bound["weights_gb"] - 51.6) <= 0.01 * 51.6
    assert bound["decode_bound_by"] == "bytes"


def test_train_check_hybrid_runs_rep_8_and_the_ssd_kernels_at_p64_n16():
    cs = _chip_smoke()
    cfg = cs.hybrid_small_config()
    assert cfg.family == "hybrid" and cfg.n_layers == 8 and cfg.d_model == 128
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) == (8, 128)
    assert (cfg.ssm.head_dim, cfg.ssm.d_state) == (64, 16)
    assert cs.moe_layer_count(cfg) == 4


def test_hybrid_layer_chain_is_loss_fn():
    """`hybrid_layer_chain` (fp32 params, reduced jamba) gives `loss_fn`'s loss
    and every gradient: the units' forwards and backwards chained are the
    model's; and forced to its own chain it gives the same again."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    from repro_torch.models import init_model, loss_fn
    from repro_torch.runtime.steps import param_grads
    from repro_torch.tree import tree_leaves, tree_map
    cfg = cs.hybrid_small_config()
    params = tree_map(lambda t: t.float(), init_model(cfg, torch.Generator().manual_seed(5),
                                                      "cpu"))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 65)))
    mask = torch.ones(2, 64)
    mask[1, 40:] = 0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}
    loss, grads, chain = cs.hybrid_layer_chain(tree_map(torch.clone, params), batch, cfg)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    want_loss, _ = loss_fn(params, batch, cfg)
    want = param_grads(want_loss, leaves)
    assert len(chain["ins"]) == len(chain["grads"]) == cfg.n_layers + 1
    np.testing.assert_allclose(float(loss), float(want_loss.detach()), rtol=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=1e-4,
                                   atol=1e-6 * float(w.abs().max()))
    again = cs.hybrid_layer_chain(tree_map(lambda t: t.detach().clone(), params), batch, cfg,
                                  forced=chain)[1]
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


def _planted(fault):
    """A wrapper of `hybrid_layer_chain` that runs the unforced chain (the
    card's side) with the flash backward's dk/dv taken from half of each GQA
    group, as a cluster that drops half its partials would give them."""
    import importlib

    cs = _chip_smoke()
    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    real_chain, real_bwd = cs.hybrid_layer_chain, ops.flash_attention_bwd

    def half_group(q, k, v, out, lse, do, **kw):
        dq, _, _ = real_bwd(q, k, v, out, lse, do, **kw)
        rep = q.shape[1] // k.shape[1]
        do2 = do.clone()
        do2[:, [h for h in range(q.shape[1]) if h % rep >= rep // 2]] = 0
        return (dq, *real_bwd(q, k, v, out, lse, do2, **kw)[1:])

    def chain(*a, forced=None, **kw):
        if forced is not None or not fault:
            return real_chain(*a, forced=forced, **kw)
        ops.flash_attention_bwd = half_group
        try:
            return real_chain(*a, **kw)
        finally:
            ops.flash_attention_bwd = real_bwd
    return chain


@pytest.mark.parametrize("fault", [False, True])
def test_hybrid_train_check_holds_each_unit(monkeypatch, fault):
    """`hybrid_train_check` with the CPU on both sides: every unit (the
    embedding, the 8 layers, the head) agrees exactly and no route flips,
    one route call a MoE layer.  With a fault planted on one side (dk/dv
    from half of each GQA group) the attention layer's unit fails the gate,
    though all gradients together stay within TOL_GRAD."""
    import torch

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "hybrid_layer_chain", _planted(fault))
    cfg = cs.hybrid_small_config()
    rec = cs.hybrid_train_check(torch.device("cpu"), cfg, 3, 192, 152)
    assert set(rec["unit_rel_l2"]) == {"embed", "head", *map(str, range(8))}
    assert rec["moe_route_calls"] == cs.moe_layer_count(cfg) == 4
    assert rec["route_flips"] == 0
    if not fault:
        assert rec["ok"] and max(rec["unit_rel_l2"].values()) == 0.0
        assert rec["rel_err_loss"] == 0.0 and rec["unforced"]["rel_l2_all_grads"] == 0.0
    else:
        attn = str(cfg.hybrid.attn_index)
        assert not rec["ok"] and rec["unit_rel_l2"][attn] > cs.TOL_GRAD
        assert rec["rel_l2_all_grads"] <= cs.TOL_GRAD
        assert max(v for u, v in rec["unit_rel_l2"].items() if u != attn) <= 1e-6

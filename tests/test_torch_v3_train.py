"""The port's deepseek-v3-671b train path against the JAX package, on the CPU.

Reduced deepseek-v3-671b (4 layers: the 3 dense ones and 1 MoE layer with
the sigmoid router, 8 experts top-2 + 1 shared, router_scale 2.5; d 128, 4
heads; MLA with q-LoRA 32, kv_lora 64, qk_nope 32, qk_rope 16, v 32; the
MTP head), weights from JAX `init_model(cfg, PRNGKey(0))` with a nonzero
`router_bias` drawn from a numpy seed, carried across with
`repro_torch.convert.from_jax_params`; batches as
tests/test_torch_moe_train.py makes them (B = 2 x S = 64, padded tails).

What this slice adds to the MoE train path, each held to JAX here:
* `loss_fn`'s MTP branch (JAX `models/transformer.py:317-327`): one more
  dense layer and its norm on the final-normed h, the chunked CE of its
  first S - 1 positions against labels shifted by one (63 = 7 chunks of 9),
  0.1 x `mtp_ce` added to the loss;
* q-LoRA's q_norm, an RMS norm at D q_lora_rank through `rmsnorm_op`, so
  that its backward is the RMSNorm backward kernel on a card;
* the sigmoid router's gradients: through sigmoid(logits), the gathered and
  renormalised top_w, router_scale and the aux loss's scores.mean(0).
  `router_bias` only shifts the selection, so its gradient is exactly zero
  on both sides (`param_grads` gives the port's zeros, as `jax.grad`).

Routing is pinned as in tests/test_torch_moe_train.py (`_selection`: JAX's
`top_k` read by a spy, the port's selection pinned to it, flips at a gap >=
chip_smoke.NEAR_TIE fail); its tolerances and `_assert_trees_close` hold
every gradient leaf, `router_bias` asserted exactly zero instead.  AdamW:
10 steps on fp32 moments at 1e-5, weight decay judged on JAX's layout.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import itertools
from dataclasses import replace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.models import layers as JL
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_tensor
from repro_torch.kernels.cross_entropy import ops as ce_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import init_model, loss_fn
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import _decay_mask
from repro_torch.runtime.steps import param_grads
from repro_torch.tree import tree_leaves
from test_torch_moe_train import (CS, TOL_BF16, TOL_F32, _assert_trees_close, _batch, _jnp,
                                  _np, _selection, _tb)

ARCH = "deepseek-v3-671b"
B, S = 2, 64


@pytest.fixture(scope="module")
def v3():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert cfg.mtp and cfg.moe.router == "sigmoid" and cfg.mla.q_lora_rank
    assert (cfg.n_layers, cfg.moe.n_dense_prefix) == (4, 3)
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    bias = np.random.default_rng(11).standard_normal((1, cfg.moe.n_experts)) * 0.1
    jp["blocks"]["ffn"]["router_bias"] = jnp.asarray(bias, jnp.float32)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32}}


# ---------------------------------------------------------------------------
# loss_fn with the MTP branch, and every gradient
# ---------------------------------------------------------------------------

def test_v3_loss_and_every_grad_match_jax_f32(v3):
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(v3, "f32", _batch(1, 512))
    assert set(metrics) == set(jm) == {"loss", "ce", "aux", "ppl", "mtp_ce"}
    for key in ("loss", "ce", "aux", "ppl", "mtp_ce"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    # loss = ce + 0.01 aux + 0.1 mtp_ce, as JAX adds them
    np.testing.assert_allclose(
        _np(loss), _np(metrics["ce"] + 0.01 * metrics["aux"] + 0.1 * metrics["mtp_ce"]),
        rtol=1e-6)
    assert float(metrics["aux"].detach()) > 0
    _assert_trees_close(tg, jg, zero=("router_bias",), **TOL_F32)
    assert not np.any(np.asarray(v3["jax"]["f32"]["blocks"]["ffn"]["router_bias"]) == 0)


def test_v3_loss_and_every_grad_match_jax_bf16(v3):
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(v3, "bf16", _batch(2, 512))
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    for key in ("ce", "aux", "mtp_ce"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), rtol=TOL_BF16,
                                   err_msg=key)
    assert tg["blocks"]["ffn"]["router"].dtype == np.float32
    assert tg["blocks"]["ffn"]["router_bias"].dtype == np.float32
    assert tg["mtp"]["layer"]["attn"]["q_norm"].dtype.name == "bfloat16"
    _assert_trees_close(tg, jg, rel=TOL_BF16, floor=0.0, zero=("router_bias",))


def test_sigmoid_router_gradients_match_jax(v3):
    """`apply_moe` of the MoE layer with the sigmoid router under autograd
    against jax.grad of JAX's, on sum(y dy) + aux so that both the combine's
    weights and the aux loss's scores carry gradient; the selection pinned
    to JAX's (its top_k read by a spy).  router_bias's gradient is exactly
    zero on both sides, every other leaf's and x's within TOL_F32."""
    jcfg, cfg = v3["jcfg"], v3["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], v3["jax"]["f32"]["blocks"]["ffn"])
    tp = from_jax_params(_jnp(v3["jax"]["f32"]), cfg)["blocks"][0]["ffn"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    calls = []
    real_top_k = jax.lax.top_k

    def spy(a, k):
        vals, idx = real_top_k(a, k)
        jax.debug.callback(lambda i, s_: calls.append((np.asarray(i), np.asarray(s_))), idx, a,
                           ordered=True)
        return vals, idx

    def jfn(p, xx):
        y, aux = JL.apply_moe(p, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux
    with mock.patch.object(jax.lax, "top_k", spy):
        (jgp, jgx) = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
        jax.effects_barrier()
    [(jidx, jsel)] = calls
    k = cfg.moe.top_k
    top = -np.sort(-jsel, axis=-1)
    leaves = {n: t.requires_grad_(True) for n, t in tp.items() if n != "shared"}
    shared = {n: t.requires_grad_(True) for n, t in tp["shared"].items()}
    tx = to_tensor(x).requires_grad_(True)
    with CS.RouteRecorder(TL) as rec:
        rec.pin = [torch.from_numpy(jidx.astype(np.int64))]
        y, aux = TL.apply_moe({**leaves, "shared": shared}, tx, cfg)
        obj = (y.float() * torch.from_numpy(dy)).sum() + aux
        [own] = rec.take()
    flips = CS.route_flips([{"idx": torch.from_numpy(jidx.astype(np.int64)),
                             "gap": torch.from_numpy(top[:, k - 1] - top[:, k])}],
                           [{"idx": own["own"], "gap": own["gap"]}])
    assert not CS.wide_flips(flips), flips
    names = sorted(leaves) + [f"shared.{n}" for n in sorted(shared)]
    got = param_grads(obj, [leaves[n] for n in sorted(leaves)]
                      + [shared[n] for n in sorted(shared)] + [tx])
    for name, g in zip(names + ["x"], got):
        want = (jgx if name == "x" else jgp["shared"][name[7:]] if name.startswith("shared.")
                else jgp[name])
        if name == "router_bias":
            assert not np.any(_np(want)) and not torch.any(g), name
            continue
        assert float(np.abs(_np(want)).max()) > TOL_F32["atol"], name
        np.testing.assert_allclose(_np(g), _np(want), err_msg=name, **TOL_F32)


# ---------------------------------------------------------------------------
# the kernels this slice's train path runs, counted on the CPU
# ---------------------------------------------------------------------------

def _count(monkeypatch):
    """Counts the calls the autograd ops make of each kernel wrapper (a CPU
    tensor runs the plain version, which counts no launch), and the row
    widths the RMSNorm backward gets."""
    calls = {name: 0 for name in CS.moe_train_launches(get_config(ARCH), S)}
    widths = []

    def spy(mod, attr, names):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            for n in names:
                calls[n] += 1
            if attr == "rmsnorm_bwd":
                widths.append(a[0].shape[-1])
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)
    spy(rms_ops, "rmsnorm", ["rmsnorm"])
    spy(rms_ops, "rmsnorm_bwd", ["rmsnorm_bwd"])
    spy(flash_ops, "flash_attention_fwd", ["flash_attention_fwd"])
    spy(flash_ops, "flash_attention_bwd", ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    spy(ce_ops, "fused_ce", ["fused_ce"])
    spy(ce_ops, "fused_ce_bwd", ["fused_ce_bwd"])
    return calls, widths


@pytest.mark.parametrize("arch,n_layers", [(ARCH, 3), (ARCH, 4), ("deepseek-v2-lite-16b", 2)])
def test_train_step_runs_the_kernels_chip_smoke_counts(monkeypatch, arch, n_layers):
    """One loss_fn and its gradients (remat per layer, 8 CE chunks) call each
    kernel wrapper as often as chip_smoke.moe_train_launches says a train
    step launches it: q_norm, an RMS norm at D q_lora_rank, goes through
    rmsnorm_op and its backward through the RMSNorm backward, once in each
    layer and in the MTP layer; the MTP loss's 63 positions run in 7 CE
    chunks."""
    cfg = replace(get_config(arch).reduced(), n_layers=n_layers)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    calls, widths = _count(monkeypatch)
    loss, metrics = loss_fn(params, _tb(_batch(4, cfg.vocab_size)), cfg)
    param_grads(loss, leaves)
    assert calls == CS.moe_train_launches(cfg, S)
    n_norm_layers = cfg.n_layers + int(cfg.mtp)
    q_lora = cfg.mla.q_lora_rank
    assert widths.count(q_lora) == (n_norm_layers if q_lora else 0)
    assert widths.count(cfg.mla.kv_lora_rank) == n_norm_layers
    assert ("mtp_ce" in metrics) == cfg.mtp
    if cfg.mtp:
        assert CS.ce_chunks_of(S - 1) == 7 and CS.ce_chunks_of(511) == 7


def test_moe_model_flops_counts_the_mtp_layer_and_q_lora():
    """chip_smoke's FLOP count of a train_v3 step (3 dense layers + MTP at
    full width, 8 x 512): 6 x the active params (4 layers' q-LoRA MLA and
    dense FFN, the head) x 4,096 tokens, the MTP head's second pass over
    8 x 511 tokens, and attention over 4 layers' causal pairs, by hand."""
    cfg = replace(get_config(ARCH), n_layers=3)
    d, h, v = 7168, 128, 129280
    mla = d * 1536 + 1536 * h * 192 + d * 576 + 512 * h * 256 + h * 128 * d
    active = 4 * (mla + 3 * d * 18432) + d * v
    pairs = 8 * h * 512 * 513 // 2
    want = 6 * active * 4096 + 6 * d * v * 8 * 511 + 6 * 320 * pairs * 4
    assert CS.moe_model_flops(cfg, 8, 512) == want
    assert 103e12 < want < 105e12
    # without MTP nothing of it is counted: deepseek-v2-lite-16b's count stands
    v2 = replace(get_config("deepseek-v2-lite-16b"), n_layers=6)
    assert not v2.mtp and 17.5e12 < CS.moe_model_flops(v2, 8, 512) < 17.6e12


# ---------------------------------------------------------------------------
# AdamW, the converter and the Trainer on the dense-prefix cut
# ---------------------------------------------------------------------------

def test_v3_adamw_ten_steps_match_jax(v3):
    """10 updates of the reduced deepseek-v3-671b params (fp32 moments) on
    identical grads, router_bias's exactly zero as the loss gives it; weight
    decay judged on JAX's layout: the stacked `blocks` leaves (q_norm and
    router_bias among them) decay, the unstacked 1-D `prefix` and `mtp`
    leaves do not."""
    cfg = v3["cfg"]
    jp = v3["jax"]["f32"]
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
    jcfg_opt, tcfg_opt = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    tp = from_jax_params(_jnp(jp), cfg)
    mask = _decay_mask(tp)
    assert mask["blocks"][0]["attn"]["q_norm"] and mask["blocks"][0]["ffn"]["router_bias"]
    assert not mask["prefix"][0]["attn"]["q_norm"]
    assert not mask["mtp"]["layer"]["attn"]["q_norm"] and not mask["mtp"]["norm"]["scale"]
    assert mask["mtp"]["layer"]["attn"]["wq_b"]
    jopt, topt = jax_init_opt_state(jp, jcfg_opt), init_opt_state(tp, tcfg_opt)
    rng = np.random.default_rng(6)
    jupd = jax.jit(jax_adamw_update, static_argnums=(3,))

    def grad_like(a, path):
        if jax.tree_util.keystr(path).endswith("['router_bias']"):
            return np.zeros(a.shape, np.float32)
        return rng.standard_normal(a.shape).astype(np.float32) * 0.3
    for _ in range(10):
        gj = jax.tree_util.tree_map_with_path(lambda p, a: grad_like(a, p), _jnp(jp))
        jp, jopt, jm = jupd(gj, jopt, jp, jcfg_opt)
        tp, topt, tm = adamw_update(from_jax_params(gj, cfg), topt, tp, tcfg_opt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(topt["step"]) == int(jopt["step"]) == 10
    got = to_jax_params(tp, cfg)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # a zero gradient leaves only the decay: router_bias shrinks by it
    bias0 = np.asarray(v3["jax"]["f32"]["blocks"]["ffn"]["router_bias"])
    assert np.all(np.abs(_np(got["blocks"]["ffn"]["router_bias"])) < np.abs(bias0))


def test_converter_round_trips_the_dense_prefix_cut():
    """At n_layers 3 deepseek-v3-671b keeps its dense prefix alone: no
    `blocks` (JAX's stacked init cannot build it), `prefix` and `mtp` cross
    both ways as they are."""
    cfg = replace(get_config(ARCH).reduced(), n_layers=3)
    params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    assert params["blocks"] == [] and len(params["prefix"]) == 3 and "mtp" in params
    out = to_jax_params(params, cfg)
    assert "blocks" not in out
    back = from_jax_params(out, cfg)
    assert back["blocks"] == []
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b.detach())


def test_trainer_trains_v3_on_its_dense_prefix_with_mtp():
    """TrainerConfig(n_layers=3) on reduced deepseek-v3-671b: the 3 dense
    layers (empty `blocks`) and the MTP head train on a fixed batch; the
    loss and the MTP head's mtp_ce fall."""
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 32), np.float32)}
    tc = TrainerConfig(arch=ARCH, n_layers=3, steps=4, global_batch=2, seq_len=32,
                       log_every=4, device="cpu")
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    assert tr.cfg == replace(cfg, n_layers=3) and tr.cfg.mtp
    out = tr.run()
    params = tr.state["params"]
    assert params["blocks"] == [] and len(params["prefix"]) == 3 and "mtp" in params
    for key in ("losses", "mtp_ces"):
        assert len(out[key]) == 4 and all(np.isfinite(out[key])), key
        assert out[key][-1] < out[key][0], (key, out[key])

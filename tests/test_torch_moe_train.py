"""The port's MoE train path against the JAX package, on the CPU.

Reduced deepseek-v2-lite-16b (4 layers, the first dense, d 128, 4 heads,
8 experts top-2 + 2 shared, kv_lora 64, qk_nope 32, qk_rope 16, v 32:
attention at q/k head dim 48 against v head dim 32), weights from JAX
`init_model(cfg, PRNGKey(0))` carried across with
`repro_torch.convert.from_jax_params`, batches of B = 2 x S = 64 tokens from
a numpy seed with padded tails.  On the CPU every kernel wrapper, and so
every autograd op's backward, runs its plain version.  JAX trains MLA
through `blocked_causal_attention` (jnp); the port through the flash
kernels, whose plain versions at D_qk != D_v are held here to JAX's
`blocked_causal_attention`, to its `attention_ref` and to its Pallas
kernels in interpret mode (those take one head dim, so v and dO enter them
zero-padded to 48 columns and out and dv are read from the first 32).

Routing: JAX's selections are read from its `jax.lax.top_k` calls by an
ordered `jax.debug.callback` spy (its forward's calls come first); the port
runs with each MoE layer's selection pinned to JAX's (chip_smoke.py's
`RouteRecorder`, the forward's calls, then the remat recompute's),
weighted by its own scores, and its own selection in each call is compared
with JAX's: any token whose experts differ is reported with its top-k gap
on both sides and fails at a gap >= chip_smoke.NEAR_TIE.

Tolerances are tests/test_torch_train.py's: fp32 params at TOL_F32 (loss,
ce, aux, ppl, every gradient), bf16 params against JAX jitted with
`xla_allow_excess_precision` off at TOL_BF16, each gradient leaf within
TOL_BF16 of its own largest |value|: `_assert_trees_close` with floor 0,
where the dense test's floor of 1 would hold every leaf whose gradients lie
below 3e-2 (here the router's, the experts', most of MLA's) to nothing.
Each leaf's largest |gradient| is printed beside the atol it is held to,
and must exceed it.  AdamW: 10 steps on fp32 moments at 1e-5.
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
from repro.kernels.flash_attention.kernel import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import init_model as jax_init_model
from repro.models import layers as JL
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_tensor
from repro_torch.kernels import flash_attention, flash_attention_bwd, flash_attention_fwd
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import decode_step, forward, init_cache, loss_fn, prefill
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.steps import param_grads
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "deepseek-v2-lite-16b"
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 3e-2
STRICT_BF16 = {"xla_allow_excess_precision": False}
B, S = 2, 64


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32}}


def _torch_params(model, dt):
    return from_jax_params(_jnp(model["jax"][dt]), model["cfg"])


def _batch(seed, vocab, b=B, s=S):
    """tokens/labels shifted by one, and a loss mask with padded tails."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    for i in range(b):
        n = int(rng.integers(s // 2, s + 1))
        toks[i, n + 1:] = 0
        mask[i, n:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _tb(batch):
    return {k: torch.as_tensor(v).long() if k != "loss_mask" else torch.as_tensor(v)
            for k, v in batch.items()}


def _jax_value_and_grad(params, batch, jcfg, strict):
    """JAX's loss, metrics and gradients, and the top_idx of each of its
    `top_k` calls in the order they ran (the forward's MoE layers first)."""
    calls = []
    real_top_k = jax.lax.top_k

    def spy(a, k):
        vals, idx = real_top_k(a, k)
        jax.debug.callback(lambda i, s: calls.append((np.asarray(i), np.asarray(s))), idx, a,
                           ordered=True)
        return vals, idx
    fn = jax.value_and_grad(jax_loss_fn, has_aux=True)
    with mock.patch.object(jax.lax, "top_k", spy):
        jitted = jax.jit(fn, static_argnums=(2,),
                         compiler_options=STRICT_BF16 if strict else None)
        (jl, jm), jg = jitted(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        jax.block_until_ready(jg)
    return jl, jm, jg, calls


def _port_grads(params, batch, cfg, pin=None):
    """The port's loss, metrics and gradients (JAX layout), and its
    RouteRecorder calls; `pin`: one top_idx a moe_route call."""
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    with CS.RouteRecorder(TL) as rec:
        rec.pin = pin
        loss, metrics = loss_fn(params, _tb(batch), cfg)
        grads = param_grads(loss, leaves)
        calls = rec.take()
    return loss, metrics, to_jax_params(tree_unflatten(params, list(grads)), cfg), calls


def _selection(model, dt, batch):
    """Runs both sides, the port with every MoE layer's selection (forward
    and remat recompute) pinned to JAX's, and compares the port's own
    selection in each call with JAX's: a flip fails at a top-k gap >=
    NEAR_TIE and is reported below it.  Returns the JAX and port results and
    the flips."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jl, jm, jg, jcalls = _jax_value_and_grad(model["jax"][dt], batch, jcfg, dt == "bf16")
    n_moe = cfg.n_layers - cfg.moe.n_dense_prefix
    assert len(jcalls) >= n_moe
    # JAX's forward calls, then the recompute's in reverse layer order (as the port's)
    k = cfg.moe.top_k
    jrec = []
    for idx, sel in jcalls[:n_moe]:
        top = -np.sort(-sel.reshape(-1, sel.shape[-1]), axis=-1)
        jrec.append({"idx": torch.from_numpy(idx.reshape(-1, k).astype(np.int64)),
                     "gap": torch.from_numpy(top[:, k - 1] - top[:, k])})
    jrec = jrec + jrec[::-1]
    loss, metrics, tg, tcalls = _port_grads(_torch_params(model, dt), batch, cfg,
                                            pin=[c["idx"] for c in jrec])
    assert len(tcalls) == 2 * n_moe
    flips = CS.route_flips(jrec, [{"idx": c["own"], "gap": c["gap"]} for c in tcalls])
    print(f"{dt}: {len(flips)} route flips of {sum(c['idx'].numel() for c in tcalls)}", flips)
    assert not CS.wide_flips(flips), flips
    return (jl, jm, jg), (loss, metrics, tg), flips


def _assert_trees_close(got, want, rel=None, floor=1.0, zero=(), **tol):
    """Every leaf of `got` (numpy, JAX layout) against `want`; with `rel`,
    within rel x max(floor, the leaf's largest |value|).  Prints each leaf's
    largest |value| and asserts it is above the atol the leaf is held to.
    A leaf whose name ends in one of `zero` is instead asserted exactly 0 on
    both sides (a gradient the loss has no path to)."""
    jax.tree_util.tree_map_with_path(lambda *a: None, want)   # same structure
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        w, g = _np(w), _np(g)
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if any(name.endswith(f"['{z}']") for z in zero):
            print(f"{name}: exactly 0 on both sides")
            assert not np.any(w) and not np.any(g), name
            continue
        if rel is not None:
            tol = dict(rtol=0, atol=rel * max(floor, float(np.abs(w).max())))
        print(f"{name}: max |grad| {float(np.abs(w).max()):.3e}, atol {tol['atol']:.3e}")
        assert float(np.abs(w).max()) > tol["atol"], f"{name} is held to nothing"
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def test_loss_and_every_grad_match_jax_f32(model):
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(model, "f32", _batch(1, 512))
    for key in ("loss", "ce", "aux", "ppl"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    assert float(metrics["aux"].detach()) > 0
    _assert_trees_close(tg, jg, **TOL_F32)


def test_loss_and_every_grad_match_jax_bf16(model):
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(model, "bf16", _batch(2, 512))
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["ce"]), _np(jm["ce"]), rtol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["aux"]), _np(jm["aux"]), rtol=TOL_BF16)
    for leaf in tree_leaves(tg):
        assert leaf.dtype.name in ("bfloat16", "float32")
    # the router's leaves are fp32 params, the rest bf16, as in JAX
    assert tg["blocks"]["ffn"]["router"].dtype == np.float32
    _assert_trees_close(tg, jg, rel=TOL_BF16, floor=0.0)


def test_aux_loss_is_the_sum_over_moe_layers_and_its_gradient_flows(model):
    """forward's aux is the sum of apply_moe's aux over the MoE blocks (none
    from the dense prefix), through each checkpointed block as an output;
    with remat and without it the same, and the router gets a gradient from
    aux alone."""
    cfg = model["cfg"]
    params = _torch_params(model, "f32")
    batch = _tb(_batch(3, cfg.vocab_size))
    auxes = []
    real = TL.apply_moe

    def spy(p, x, c):
        y, a = real(p, x, c)
        auxes.append(a)
        return y, a
    with mock.patch.object(TL, "apply_moe", spy), torch.no_grad():
        _, aux = forward(params, batch, replace(cfg, remat="none"))
    assert len(auxes) == cfg.n_layers - cfg.moe.n_dense_prefix
    assert float(aux) == pytest.approx(float(sum(auxes)), rel=1e-6)
    routers = [lp["ffn"]["router"].requires_grad_(True) for lp in params["blocks"]]
    for remat in ("layer", "none"):
        _, aux = forward(params, batch, replace(cfg, remat=remat))
        grads = torch.autograd.grad(aux, routers)
        assert all(float(g.abs().max()) > 0 for g in grads)


# ---------------------------------------------------------------------------
# MLA's expanded branch, and flash at D_qk != D_v
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_expanded_branch_matches_jax(model, dt, grad):
    """`mla_fwd` without a cache (the train path, through the flash op)
    against JAX's no-cache branch (blocked_causal_attention) in the first
    MoE layer; with `grad`, the gradients of x and of every MLA param by
    jax.vjp against autograd."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"][dt]["blocks"]["attn"])
    tp = from_jax_params(_jnp(model["jax"][dt]), cfg)["blocks"][0]["attn"]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), dtype)
    dy = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), dtype)
    positions = np.arange(S)
    tol = TOL_F32 if dt == "f32" else dict(rtol=TOL_BF16, atol=TOL_BF16)

    def jfn(p, xx):
        return JL.mla_fwd(p, xx, jcfg, jnp.asarray(positions))[0]
    jy, vjp = jax.vjp(jfn, jp, x)
    tx = to_tensor(x)
    if not grad:
        with torch.no_grad():
            ty, cache = TL.mla_fwd(tp, tx, cfg, torch.as_tensor(positions))
        assert cache is None and ty.dtype == tx.dtype and ty.shape == tx.shape
        np.testing.assert_allclose(_np(ty), _np(jy), **tol)
        return
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    ty, _ = TL.mla_fwd(leaves, tx, cfg, torch.as_tensor(positions))
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    names = sorted(leaves)
    tg = torch.autograd.grad(ty, [leaves[n] for n in names] + [tx], to_tensor(dy))
    jgp, jgx = vjp(dy)
    for name, got in zip(names + ["x"], tg):
        want = jgx if name == "x" else jgp[name]
        scale = 1.0 if dt == "f32" else float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


def _pad(a, d):
    return np.concatenate([a, np.zeros(a.shape[:-1] + (d - a.shape[-1],), a.dtype)], -1)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,s", [(2, 4, 64), (1, 2, 96)])
def test_flash_plain_at_dqk_48_dv_32_matches_jax(b, h, s, dt):
    """The flash op's plain passes at q/k head dim 48 and v head dim 32 (the
    reduced MLA's) against JAX: the forward against blocked_causal_attention
    (which takes D_v != D_qk) and attention_ref; the forward's out and lse
    and the backward against the Pallas kernels in interpret mode, v and dO
    zero-padded to 48 for them; the op's gradients against jax.grad of
    blocked_causal_attention."""
    import ml_dtypes
    npdt = np.float32 if dt == "f32" else ml_dtypes.bfloat16
    tol = dict(rtol=2e-3, atol=2e-3) if dt == "f32" else dict(rtol=TOL_BF16, atol=TOL_BF16)
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((b, h, s, 48), dtype=np.float32).astype(npdt) for _ in range(2))
    v, do = (rng.standard_normal((b, h, s, 32), dtype=np.float32).astype(npdt) for _ in range(2))
    scale = 1.0 / np.sqrt(48)
    to_bshd = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)      # noqa: E731
    jblk = JL.blocked_causal_attention(to_bshd(q), to_bshd(k), to_bshd(v), scale)
    tout, tlse = flash_attention_fwd(*(to_tensor(np.asarray(a)) for a in (q, k, v)))
    assert tuple(tout.shape) == (b, h, s, 32)
    np.testing.assert_allclose(_np(tout), _np(jblk.transpose(0, 2, 1, 3)), **tol)
    vp, dop = _pad(v, 48), _pad(do, 48)
    jref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp))
    np.testing.assert_allclose(_np(tout), _np(jref[..., :32]), **tol)
    jo, jl = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp),
                              block_q=32, block_kv=32, interpret=True)
    np.testing.assert_allclose(_np(tout), _np(jo[..., :32]), **tol)
    np.testing.assert_allclose(_np(tlse), _np(jl), **tol)
    jq, jk, jv = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(vp), jo, jl,
                               jnp.asarray(dop), block_q=32, block_kv=32, interpret=True)
    tq, tk, tv = flash_attention_bwd(*(to_tensor(np.asarray(a)) for a in
                                       (q, k, v, jo[..., :32], jl, do)))
    assert tuple(tq.shape) == (b, h, s, 48) and tuple(tv.shape) == (b, h, s, 32)
    for got, want in ((tq, jq), (tk, jk), (tv, jv[..., :32])):
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    def jloss(q_, k_, v_):
        out = JL.blocked_causal_attention(to_bshd(q_), to_bshd(k_), to_bshd(v_), scale)
        return jnp.sum(out.astype(jnp.float32) * to_bshd(do).astype(jnp.float32))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [to_tensor(np.asarray(a)).requires_grad_(True) for a in (q, k, v)]
    tg = torch.autograd.grad(flash_attention(*leaves, scale), leaves, to_tensor(do))
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol["rtol"],
                                   atol=tol["atol"] * float(np.abs(_np(want)).max()))


# ---------------------------------------------------------------------------
# AdamW, the Trainer, decode against the full forward
# ---------------------------------------------------------------------------

def test_adamw_ten_steps_match_jax(model):
    """10 updates of the reduced deepseek-v2-lite-16b params (fp32 moments)
    on identical grads, the dense prefix, the MoE blocks' experts and the
    fp32 router included, decay on JAX's layout."""
    cfg = model["cfg"]
    jp = model["jax"]["f32"]
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
    jcfg_opt, tcfg_opt = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    tp = from_jax_params(_jnp(jp), cfg)
    jopt, topt = jax_init_opt_state(jp, jcfg_opt), init_opt_state(tp, tcfg_opt)
    rng = np.random.default_rng(6)
    jupd = jax.jit(jax_adamw_update, static_argnums=(3,))
    for _ in range(10):
        gj = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3, _jnp(jp))
        jp, jopt, jm = jupd(gj, jopt, jp, jcfg_opt)
        tp, topt, tm = adamw_update(from_jax_params(gj, cfg), topt, tp, tcfg_opt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(topt["step"]) == int(jopt["step"]) == 10
    got = to_jax_params(tp, cfg)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_trainer_cuts_depth_and_its_loss_falls():
    """TrainerConfig.n_layers keeps the config's first layers (the dense
    prefix first) and no width changes; two layers of reduced
    deepseek-v2-lite-16b train on a fixed batch and the loss falls."""
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 32), np.float32)}
    tc = TrainerConfig(arch=ARCH, n_layers=2, steps=4, global_batch=2, seq_len=32,
                       log_every=4, device="cpu")
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    assert tr.cfg == replace(cfg, n_layers=2)
    out = tr.run()
    params = tr.state["params"]
    assert len(params["prefix"]) == 1 and len(params["blocks"]) == 1
    assert "router" in params["blocks"][0]["ffn"]
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert TrainerConfig().n_layers is None
    with pytest.raises(ValueError, match="n_layers"):
        Trainer(TrainerConfig(arch=ARCH, n_layers=5, device="cpu"))


SERVED = ["chatglm3-6b", "stablelm-3b", "mamba2-130m", "deepseek-v2-lite-16b",
          "deepseek-v3-671b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", [
    pytest.param(a, marks=pytest.mark.xfail(
        reason="as tests/test_arch_smoke.py's: MLA's absorbed bf16 decode against the "
               "full-sequence expanded path, a numerics gap just over the 0.2 tolerance "
               "on JAX's seeded config", strict=False))
    if a == "deepseek-v2-lite-16b" else a for a in SERVED])
def test_decode_matches_full_forward(arch):
    """The port of tests/test_arch_smoke.py::test_decode_matches_full_forward
    for every arch the port serves: teacher-forced decode reproduces the
    full-sequence forward's logits (MoE with capacity_factor n_experts /
    top_k, so that no route drops), at 0.2, with JAX's non-strict xfail for
    deepseek-v2-lite-16b.  deepseek-v3-671b's forward runs with mtp off:
    JAX's forward never runs the MTP head (its loss_fn does), and the port
    refuses to train a config with it."""
    from repro_torch.models import layers as TLayers
    cfg = get_config(arch).reduced()
    jp, _ = jax_init_model(jax_get_config(arch).reduced(), jax.random.PRNGKey(0))
    params = from_jax_params(_jnp(jp), cfg)
    if cfg.moe is not None:
        cfg = replace(cfg, mtp=False, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                                  / cfg.moe.top_k))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 16)))
    with torch.no_grad():
        h, _ = forward(params, {"tokens": toks}, cfg)
        full = TLayers.lm_logits(params["embed"], h, cfg)
        cache = init_cache(cfg, B, 16, "cpu")
        _, cache = prefill(params, {"tokens": toks[:, :8]}, cfg, cache)
        for i in range(8, 16):
            step, cache = decode_step(params, {"tokens": toks[:, i:i + 1]}, cfg, cache, i)
            np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, i]), rtol=0.2, atol=0.2,
                                       err_msg=f"{arch} position {i}")


# ---------------------------------------------------------------------------
# what the wrappers hand the kernels (entry points faked: no card here)
# ---------------------------------------------------------------------------

class _LooksCuda(torch.Tensor):
    """A CPU tensor that answers is_cuda = True (the C entry point is faked)."""

    @property
    def is_cuda(self):
        return True


def _cuda_like(t):
    return torch.Tensor._make_subclass(_LooksCuda, t)


def _fake_entries(monkeypatch):
    from repro_torch.kernels import _build
    calls = []

    def function(name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return call
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


def test_flash_wrappers_hand_the_kernels_head_dims_192_and_128(monkeypatch):
    """On a CUDA tensor every pass hands its kernel D 192 and DV 128 beside
    each other (the forward's arguments 9 and 10, the backward passes' 13 and
    14) and the caller's tensors, and allocates out and dv at 128 columns, q
    and k's gradients at 192; an unlisted pair raises before any call."""
    from repro_torch.kernels.flash_attention import kernel as fk
    calls = _fake_entries(monkeypatch)
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.bfloat16):
        return _cuda_like(torch.randn(*shape, generator=g).to(dt))
    q, k, v, do = r(1, 2, 16, 192), r(1, 2, 16, 192), r(1, 2, 16, 128), r(1, 2, 16, 128)
    out, lse = fk.flash_attention_fwd(q, k, v)
    dq, delta = fk.flash_attention_bwd_dq(q, k, v, _cuda_like(out), do,
                                          r(1, 2, 16, dt=torch.float32))
    dk, dv = fk.flash_attention_bwd_dkv(q, k, v, do, r(1, 2, 16, dt=torch.float32),
                                        r(1, 2, 16, dt=torch.float32))
    assert [(name, args[0]) for name, args in calls] == [
        (f"flash_attention_{p}_bf16", q.data_ptr()) for p in ("fwd", "bwd_dq", "bwd_dkv")]
    assert calls[0][1][9:11] == (192, 128)
    assert calls[1][1][13:15] == (192, 128) and calls[2][1][13:15] == (192, 128)
    assert out.shape == (1, 2, 16, 128) and dq.shape == dk.shape == (1, 2, 16, 192)
    assert dv.shape == (1, 2, 16, 128)
    with pytest.raises(ValueError, match="head dims"):
        fk.flash_attention_fwd(v, v, q)          # (128, 192) is not a listed pair
    assert len(calls) == 3


def test_rmsnorm_bwd_wrapper_hands_the_kernel_kv_norms_rows_in_place(monkeypatch):
    """kv_norm's backward: the wrapper passes the slice's own data pointer
    and its row pitch 576 (no copy) and allocates a contiguous dx."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    calls = _fake_entries(monkeypatch)
    base = _cuda_like(torch.randn(2, 8, 576).to(torch.bfloat16))
    x = base[..., :512]
    scale = _cuda_like(torch.ones(512, dtype=torch.bfloat16))
    dy = _cuda_like(torch.randn(2, 8, 512).to(torch.bfloat16))
    dx, _ = rk.rmsnorm_bwd(x, scale, dy)
    [(name, args)] = calls
    assert name == "rmsnorm_bwd_bf16" and args[0] == base.data_ptr()
    assert args[7:10] == (16, 512, 576)
    assert dx.is_contiguous() and dx.shape == x.shape

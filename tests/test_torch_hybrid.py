"""The port's hybrid (Jamba) family against the JAX package, on the CPU.

Reduced jamba-1.5-large-398b (one period block of 8 layers: attention at
index 4, seven Mamba2 layers, an MoE FFN on layers 1, 3, 5 and 7 with 8
experts top-2, dense SwiGLU FFNs elsewhere; d 128, 4 heads of dim 32, SSD
heads of dim 32 with d_state 32 and chunk 32, vocab 512): weights from JAX
`init_model(cfg, PRNGKey(0))`, carried across with
`repro_torch.convert.from_jax_params`, inputs from numpy seeds.  On the CPU
every kernel wrapper, and so every autograd op's backward, runs its plain
version.

Routing: the loss and gradient tests pin each MoE layer's selection in the
port to JAX's, read from its `jax.lax.top_k` calls
(tests/test_torch_moe_train.py's helpers: the forward's calls, then the
remat recompute's, which JAX and the port both run block by block in
reverse, each block's layers in order), and fail a flip at a top-k gap >=
chip_smoke.NEAR_TIE.

Tolerances are tests/test_torch_moe.py's and tests/test_torch_moe_train.py's:
* prefill and decode logits and the caches: bf16 params by the relative L2
  error <= TOL_BF16 = 3e-2, fp32 params at 1e-2 elementwise (the bf16
  cache leaves, KV and conv, to one bf16 ulp).  As in tests/test_torch_ssm.py,
  the Mamba layers' fp32 sums run in another order on each side (the port's
  prompt through the chunked scan, JAX's through the recurrence) and are
  rounded to bf16 before the gated norm, so with bf16 params a value lands
  one ulp apart now and then and later layers amplify it past 3e-2
  elementwise while the logits as a whole stay close; a decode step reads
  the conv state from the bf16 cache, so with fp32 params too an ulp there
  moves the next logits by ~1e-3.  The MoE selections of each step are
  pinned to JAX's: at d 128 the router's scores of a token can tie within
  1e-5, and a flip moves its logits by a whole expert's share;
* the loss and every gradient: fp32 params at TOL_F32 = 1e-4, the aux loss
  at rtol 1e-5; bf16 params: the loss at TOL_BF16, every gradient leaf
  unit by unit (each layer, the embedding and the head on the same
  operands on both sides) within TOL_BF16 of its largest |value| (see the
  test);
* AdamW steps through `train_step`: fp32 at TOL_F32 (see `_params_close`).
The JAX references (whole model, and each layer of the unit-by-unit test)
are jitted with `xla_allow_excess_precision` off, as in
tests/test_torch_serve.py.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import itertools
from dataclasses import asdict, replace
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.runtime.steps import train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_numpy
from repro_torch.kernels.cross_entropy import ops as ce_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.serve import Server
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import decode_step, forward, init_cache, init_model, loss_fn, prefill
from repro_torch.models import layers as TL
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_state, param_grads, train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "jamba-1.5-large-398b"
B, S, MAX_LEN = 2, 32, 48
TOL_SERVE_F32 = dict(rtol=1e-2, atol=1e-2)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 3e-2
STRICT_BF16 = {"xla_allow_excess_precision": False}
jax_prefill_strict = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
jax_decode_strict = jax.jit(jax_decode_step, static_argnums=(2,),
                            compiler_options=STRICT_BF16)


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MT = _module("test_torch_moe_train")       # the pinned loss-and-gradient helpers
CS = MT.CS


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(tokens):
    return torch.as_tensor(tokens, dtype=torch.long)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32},
            "torch": {d: from_jax_params(jax.tree_util.tree_map(np.asarray, p), cfg)
                      for d, p in (("bf16", jp), ("f32", jp32))}}


def _moe_layers(cfg):
    """MoE layers of each period block, in order."""
    hy = cfg.hybrid
    return [i for i in range(hy.period) if i % hy.moe_every == 1]


# ---------------------------------------------------------------------------
# config, params, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_config_values_and_reduced_match_jax(full):
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    assert asdict(tc) == asdict(jc)
    assert tc.family == "hybrid" and tc.hybrid.period == 8


def test_convert_round_trips_hybrid_params_bit_for_bit(model):
    """JAX -> port -> JAX gives every leaf back bit for bit: the stacked
    [NB, ...] period blocks are one dict a block in the port, each holding
    its 8 layer dicts; the MoE router and the SSM's A_log, D and dt_bias
    stay fp32."""
    jp, tp, cfg = model["jax"]["bf16"], model["torch"]["bf16"], model["cfg"]
    assert len(tp["blocks"]) == cfg.n_layers // cfg.hybrid.period == 1
    layers = tp["blocks"][0]["layers"]
    assert len(layers) == 8
    for i, lp in enumerate(layers):
        assert set(lp) == {"mixer_norm", "mixer", "ffn_norm", "ffn"}
        assert ("wq" in lp["mixer"]) == (i == cfg.hybrid.attn_index)
        assert ("router" in lp["ffn"]) == (i in _moe_layers(cfg))
    assert layers[1]["ffn"]["router"].dtype == torch.float32
    assert layers[0]["mixer"]["A_log"].dtype == torch.float32
    back = to_jax_params(tp, cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        got = flat_b[path]
        assert got.dtype == a.dtype and got.shape == a.shape, jax.tree_util.keystr(path)
        assert a.tobytes() == got.tobytes(), jax.tree_util.keystr(path)
    with pytest.raises(ValueError, match="blocks"):
        to_jax_params({**tp, "blocks": tp["blocks"] * 2}, cfg)


def test_init_model_and_cache_match_jax_leaf_by_leaf(model):
    """The port's own init and cache have JAX's leaves: the same names (in
    the same order), shapes and dtypes, the blocks restacked as JAX stacks
    them; the cache is zeros."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    p = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = model["jax"]["bf16"]
    got = jax.tree_util.tree_leaves_with_path(to_jax_params(p, cfg))
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)
    c = init_cache(cfg, B, MAX_LEN, "cpu")
    jc = jax_init_cache(jcfg, B, MAX_LEN)
    got = jax.tree_util.tree_leaves_with_path(tree_map(to_numpy, c))
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jc))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 4
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)
        assert not np.any(g.astype(np.float32))


# ---------------------------------------------------------------------------
# the serve path
# ---------------------------------------------------------------------------

_JAX_CALLS = []        # (top_idx, selection scores) of each traced top_k call, in order
_REAL_TOP_K = jax.lax.top_k


def _top_k_spy(a, k):
    vals, idx = _REAL_TOP_K(a, k)
    jax.debug.callback(lambda i, s: _JAX_CALLS.append((np.asarray(i), np.asarray(s))), idx, a,
                       ordered=True)
    return vals, idx


def _jax_routed(fn, *args):
    """A JAX serve step, jitted strict, and its MoE layers' selections (with
    the top-k gap of each token) in call order, read from its
    `jax.lax.top_k` calls.  JAX reuses a trace across `jax.jit` wrappers of
    one function, so the spy appends to one module-level list."""
    _JAX_CALLS.clear()
    with mock.patch.object(jax.lax, "top_k", _top_k_spy):
        out = jax.jit(fn, static_argnums=(2,), compiler_options=STRICT_BF16)(*args)
        jax.block_until_ready(out)
        jax.effects_barrier()
    calls = list(_JAX_CALLS)
    k = args[2].moe.top_k
    routes = []
    for idx, sel in calls:
        top = -np.sort(-sel.reshape(-1, sel.shape[-1]), axis=-1)
        routes.append({"idx": torch.from_numpy(idx.reshape(-1, k).astype(np.int64)),
                       "gap": torch.from_numpy(top[:, k - 1] - top[:, k])})
    return out, routes


def _port_pinned(fn, routes, *args):
    """A port serve step with each MoE layer's selection pinned to JAX's
    `routes`; a flip of the port's own selection fails at a top-k gap >=
    NEAR_TIE and is printed below it."""
    with torch.inference_mode(), CS.RouteRecorder(TL) as rec:
        rec.pin = [c["idx"] for c in routes]
        out = fn(*args)
        calls = rec.take()
    assert len(calls) == len(routes)
    flips = CS.route_flips(routes, [{"idx": c["own"], "gap": c["gap"]} for c in calls])
    print(f"{len(flips)} route flips", flips)
    assert not CS.wide_flips(flips), flips
    return out


def _close(got, want, dt, what):
    """The bounds of the module docstring: fp32 elementwise, bf16 by the
    relative L2 error."""
    got, want = _np(got), _np(want)
    if dt == "f32":
        np.testing.assert_allclose(got, want, **TOL_SERVE_F32, err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= TOL_BF16, f"{what}: relative L2 error {rel}"


def _cache_close(tc, jc, dt, what):
    """The cache leaf by leaf, names and order as JAX's.  With fp32 params
    the bf16 leaves (KV, conv) are held to one bf16 ulp (rtol 2^-7, atol
    1e-3; tests/test_torch_ssm.py's rule for the conv state): values that
    agree to 1e-4 before the cast round apart now and then; the fp32 scan
    states as the logits."""
    got = jax.tree_util.tree_leaves_with_path(tree_map(to_numpy, tc))
    want = jax.tree_util.tree_leaves_with_path(jc)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, g), (_, w) in zip(got, want):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert g.dtype == w.dtype, name
        if dt == "f32" and w.dtype == jnp.bfloat16:
            np.testing.assert_allclose(_np(g), _np(w), rtol=2.0 ** -7, atol=1e-3, err_msg=name)
        else:
            _close(g, w, dt, name)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_prefill_and_teacher_forced_decode_match_jax(model, dt):
    """Prefill logits of [2, 32] prompts and the cache after it (the
    attention layer's KV, the Mamba layers' conv and scan states), then three
    decode steps fed the same tokens on both sides, each step's logits, and
    the cache after them; each step's MoE selections pinned to JAX's."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    (jl, jc), routes = _jax_routed(jax_prefill, jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                                   jax_init_cache(jcfg, B, MAX_LEN))
    tl, tc = _port_pinned(prefill, routes, tp, {"tokens": _t(toks[:, :S])}, cfg,
                          init_cache(cfg, B, MAX_LEN, "cpu"))
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, dt, "prefill")
    _cache_close(tc, jc, dt, "prefill")
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        (jl, jc), routes = _jax_routed(jax_decode_step, jp, {"tokens": jnp.asarray(step)},
                                       jcfg, jc, jnp.int32(S + i))
        tl, tc = _port_pinned(decode_step, routes, tp, {"tokens": _t(step)}, cfg, tc, S + i)
        _close(tl, jl, dt, f"step {i}")
    _cache_close(tc, jc, dt, "after 3 steps")


def test_prefill_then_decode_matches_longer_prefill_at_full_capacity(model):
    """The port against itself, as chip_smoke.py's cross_check_hybrid: the
    last logits of a 33-token prefill and of a 32-token prefill plus one
    decode step (the scan's final state, then the recurrence; flash, then
    decode attention), capacity_factor n_experts / top_k."""
    cfg = model["cfg"]
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tp = model["torch"]["bf16"]
    toks = _t(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 1)))
    with torch.inference_mode():
        full, _ = prefill(tp, {"tokens": toks}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        _, c = prefill(tp, {"tokens": toks[:, :S]}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        step, _ = decode_step(tp, {"tokens": toks[:, S:]}, cfg, c, S)
    assert (step - full).abs().max() <= 3e-2 * full.abs().max()


def test_cross_check_hybrid_runs_both_decode_steps_from_the_prefills_cache(monkeypatch):
    """chip_smoke.py's cross_check_hybrid (`moe_cross_check`) on the CPU: the
    pinned decode step starts from a copy of the prefill's cache, not from
    the states the unpinned step advanced, so with no flip the two steps
    are the same computation and give the same logits, within the gate."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    srv = Server(ARCH, max_len=MAX_LEN, device="cpu", seed=2)
    prompts = np.random.default_rng(12).integers(1, srv.cfg.vocab_size, (B, S + 1))
    rec = CS.moe_cross_check(srv, prompts, "cpu", MAX_LEN)
    assert rec["finite"] and rec["routes"] == len(_moe_layers(srv.cfg)) * B
    assert rec["route_flips"] == 0
    assert rec["pinned"] == rec["unpinned"]
    assert rec["pinned"]["rel_err"] <= CS.TOL_CROSS


def test_server_serves_hybrid_on_cpu_and_defaults_to_cuda():
    a = Server(ARCH, max_len=24, device="cpu", seed=1)
    b = Server(ARCH, max_len=24, device="cpu", seed=1)
    layer = a.params["blocks"][0]["layers"][1]
    assert torch.equal(layer["ffn"]["wo"], b.params["blocks"][0]["layers"][1]["ffn"]["wo"])
    prompts = np.random.default_rng(9).integers(0, a.cfg.vocab_size, (B, 8)).astype(np.int32)
    out = a.generate(prompts, 4)
    assert out["tokens"].shape == (B, 4) and out["finite"]
    np.testing.assert_array_equal(out["tokens"], b.generate(prompts, 4)["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Server(ARCH)


# ---------------------------------------------------------------------------
# the train path: loss_fn and every gradient, pinned to JAX's routing
# ---------------------------------------------------------------------------

def _recompute_order(calls, cfg):
    """JAX's forward calls followed by the remat recompute's: the blocks in
    reverse, each block's MoE layers in order."""
    per = len(_moe_layers(cfg))
    blocks = [calls[i:i + per] for i in range(0, len(calls), per)]
    return calls + [c for blk in reversed(blocks) for c in blk]


def _selection(model, dt, batch):
    """Both sides, the port with every MoE layer's selection pinned to
    JAX's; a flip of the port's own selection fails at a gap >= NEAR_TIE."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jl, jm, jg, jcalls = MT._jax_value_and_grad(model["jax"][dt], batch, jcfg, dt == "bf16")
    n_moe = cfg.n_layers // cfg.hybrid.period * len(_moe_layers(cfg))
    k = cfg.moe.top_k
    jrec = []
    for idx, sel in jcalls[:n_moe]:
        top = -np.sort(-sel.reshape(-1, sel.shape[-1]), axis=-1)
        jrec.append({"idx": torch.from_numpy(idx.reshape(-1, k).astype(np.int64)),
                     "gap": torch.from_numpy(top[:, k - 1] - top[:, k])})
    jrec = _recompute_order(jrec, cfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, model["jax"][dt]), cfg)
    loss, metrics, tg, tcalls = MT._port_grads(params, batch, cfg,
                                               pin=[c["idx"] for c in jrec])
    assert len(tcalls) == 2 * n_moe
    flips = CS.route_flips(jrec, [{"idx": c["own"], "gap": c["gap"]} for c in tcalls])
    print(f"{dt}: {len(flips)} route flips", flips)
    assert not CS.wide_flips(flips), flips
    return (jl, jm, jg), (loss, metrics, tg), [c["idx"] for c in jrec]


def test_loss_and_every_grad_match_jax_f32(model):
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(model, "f32", MT._batch(1, 512))
    for key in ("loss", "ce", "ppl"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(metrics["aux"]), _np(jm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    assert float(metrics["aux"].detach()) > 0
    MT._assert_trees_close(tg, jg, **TOL_F32)


def _rel_l2(got, want):
    """Relative L2 error of all leaves of `got` against `want` taken together
    (numpy trees of one structure), and of each leaf."""
    leaves = [(jax.tree_util.keystr(path), _np(g), _np(w)) for (path, w), g in
              zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got))]
    per_leaf = {name: float(np.linalg.norm(g - w) / np.linalg.norm(w)) for name, g, w in leaves}
    return (float(np.linalg.norm(np.concatenate([(g - w).ravel() for _, g, w in leaves]))
                  / np.linalg.norm(np.concatenate([w.ravel() for _, _, w in leaves]))), per_leaf)


def _jax_layer(jcfg, lp, i, h, positions):
    """Layer i of a period block alone: the loop body of JAX's
    `_apply_hybrid_block` without a cache (its sharding constraints are the
    identity on one device).  Returns (h, aux), aux 0 for a dense FFN."""
    hy = jcfg.hybrid
    x = JL.apply_norm(lp["mixer_norm"], h)
    y = (JL.attention_fwd(lp["mixer"], x, jcfg, positions)[0] if i == hy.attn_index
         else JS.ssm_fwd(lp["mixer"], x, jcfg)[0])
    h = h + y
    x = JL.apply_norm(lp["ffn_norm"], h)
    if i % hy.moe_every == 1:
        y, aux = JL.apply_moe(lp["ffn"], x, jcfg)
    else:
        y, aux = JL.apply_mlp(lp["ffn"], x, jcfg), jnp.float32(0.0)
    return h + y, aux


def _jax_units(jp, jcfg, batch, chain):
    """JAX's gradients of `loss_fn` unit by unit, on the port's operands:
    the embedding, each layer (`_jax_layer`, jitted strict, one trace a
    kind of layer) and the head (final_norm and `_chunked_ce`), each from
    the input `chain["ins"]` gives it and the gradient `chain["grads"]`
    gives at its output.  Returns (the gradient tree, JAX layout; the
    gradient at each unit's input; each MoE layer's selection, in layer
    order, read from its `top_k` calls)."""
    hy = jcfg.hybrid
    j = lambda t: jnp.asarray(to_numpy(t))          # noqa: E731
    kinds = {}

    def layer_vjp(i):
        kind = hy.attn_index if i == hy.attn_index else int(i % hy.moe_every == 1)
        if kind not in kinds:
            def fn(lp, x, g):
                _, vjp = jax.vjp(lambda p_, x_: _jax_layer(jcfg, p_, kind, x_,
                                                            jnp.arange(x_.shape[1])), lp, x)
                return vjp((g, jnp.float32(CS.AUX_WEIGHT)))
            kinds[kind] = jax.jit(fn, compiler_options=STRICT_BF16)
        return kinds[kind]

    _JAX_CALLS.clear()
    layers, at_input = [], []
    with mock.patch.object(jax.lax, "top_k", _top_k_spy):
        for i in range(hy.period):
            lp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["layers"][i])
            glp, gx = layer_vjp(i)(lp, j(chain["ins"][i]), j(chain["grads"][i + 1]))
            layers.append(jax.tree_util.tree_map(lambda a: a[None], glp))
            at_input.append(gx)
        jax.effects_barrier()
    routes = []
    for idx, sel in _JAX_CALLS:
        top = -np.sort(-sel.reshape(-1, sel.shape[-1]), axis=-1)
        k = jcfg.moe.top_k
        routes.append({"idx": torch.from_numpy(idx.reshape(-1, k).astype(np.int64)),
                       "gap": torch.from_numpy(top[:, k - 1] - top[:, k])})

    def head(emb, fnorm, h):
        nll, msum = JT._chunked_ce(emb, JL.apply_norm(fnorm, h), jnp.asarray(batch["labels"]),
                                   jnp.asarray(batch["loss_mask"]), jcfg)
        return nll / jnp.maximum(msum, 1.0)
    _, vjp = jax.vjp(head, jp["embed"], jp["final_norm"], j(chain["ins"][-1]))
    g_emb, g_fnorm, g_h = vjp(jnp.float32(1.0))
    _, vjp = jax.vjp(lambda e: JL.embed_tokens(e, jnp.asarray(batch["tokens"])), jp["embed"])
    g_tok, = vjp(j(chain["grads"][0]))
    grads = {"embed": jax.tree_util.tree_map(jnp.add, g_emb, g_tok), "final_norm": g_fnorm,
             "blocks": {"layers": layers}}
    return grads, at_input + [g_h], routes


def test_loss_and_every_grad_match_jax_bf16(model):
    """bf16 params: the loss, ce and aux at TOL_BF16; every gradient leaf
    unit by unit within TOL_BF16 of its own largest |value|
    (`MT._assert_trees_close`, floor 0, tests/test_torch_moe_train.py's bf16
    rule), and so the gradient at each unit's input.  The units are
    chip_smoke.py's `hybrid_layer_chain`: the port's own chain gives each
    unit (the embedding, each layer, the head) its input and the gradient at
    its output; JAX runs the same unit on them (`_jax_units`), and the port
    the same chain forced to those operands with each MoE layer's selection
    pinned to JAX's (a flip fails at a gap >= NEAR_TIE).

    The whole model is printed beside it, not held: with the routing fixed,
    reduced jamba's bf16 gradients (JAX's and the port's alike) lie 25-30 %
    (relative L2) from the fp32 gradients of the same weights, and the
    port's lie 4.3 % from JAX's, 84 of the 107 leaves past TOL_BF16 of
    their largest |value|: each Mamba layer rounds its gated output to
    bf16, so a last-bit difference of an fp32 sum becomes a bf16 ulp now
    and then, and the seven Mamba layers of a block amplify it (PERF.md,
    PR 25).  Unit by unit the port reads 1.6e-3 of JAX's (all leaves), its
    worst leaf 2.1e-2 of its largest |value| (a conv_b: a sum over the
    tokens)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = MT._batch(2, 512)
    (jl, jm, jg), (loss, metrics, tg), _ = _selection(model, "bf16", batch)
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["ce"]), _np(jm["ce"]), rtol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["aux"]), _np(jm["aux"]), rtol=TOL_BF16)
    print("whole model, port vs JAX, relative L2 of all gradients:", _rel_l2(tg, jg)[0])
    params = model["torch"]["bf16"]
    tb = MT._tb(batch)
    _, _, chain = CS.hybrid_layer_chain(tree_map(torch.clone, params), tb, cfg)
    want, want_in, routes = _jax_units(model["jax"]["bf16"], jcfg, batch, chain)
    assert len(routes) == len(_moe_layers(cfg)) == 4
    with CS.RouteRecorder(TL) as rec:
        rec.pin = [c["idx"] for c in routes]
        got_loss, got, got_chain = CS.hybrid_layer_chain(tree_map(torch.clone, params), tb,
                                                         cfg, forced=chain)
        calls = rec.take()
    flips = CS.route_flips(routes, [{"idx": c["own"], "gap": c["gap"]} for c in calls])
    print(f"{len(flips)} route flips", flips)
    assert not CS.wide_flips(flips), flips
    np.testing.assert_allclose(_np(got_loss), _np(jl), rtol=TOL_BF16)
    MT._assert_trees_close(to_jax_params(tree_unflatten(params, got), cfg), want,
                           rel=TOL_BF16, floor=0.0)
    MT._assert_trees_close(got_chain["grads"], want_in, rel=TOL_BF16, floor=0.0)


def test_aux_loss_is_the_sum_over_the_blocks_moe_layers(model):
    """forward's aux is the sum of apply_moe's aux over each block's four MoE
    layers, through the checkpointed block as an output: the same with remat
    and without, and each router gets a gradient from aux alone."""
    cfg = model["cfg"]
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, model["jax"]["f32"]), cfg)
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    auxes = []
    real = TL.apply_moe

    def spy(p, x, c):
        y, a = real(p, x, c)
        auxes.append(a)
        return y, a
    with mock.patch.object(TL, "apply_moe", spy), torch.no_grad():
        _, aux = forward(params, {"tokens": toks}, replace(cfg, remat="none"))
    assert len(auxes) == len(_moe_layers(cfg)) == 4
    assert float(aux) == pytest.approx(float(sum(auxes)), rel=1e-6)
    routers = [params["blocks"][0]["layers"][i]["ffn"]["router"].requires_grad_(True)
               for i in _moe_layers(cfg)]
    for remat in ("layer", "none"):
        _, aux = forward(params, {"tokens": toks}, replace(cfg, remat=remat))
        grads = torch.autograd.grad(aux, routers)
        assert all(float(g.abs().max()) > 0 for g in grads)


# ---------------------------------------------------------------------------
# train_step and the Trainer
# ---------------------------------------------------------------------------

def _port_state(jstate, cfg, opt_cfg):
    """JAX's train state (params, AdamW moments and step) as the port's."""
    def conv(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg)
    state = make_train_state(cfg, opt_cfg, params=conv(jstate["params"]))
    state["opt"] = {"m": conv(jstate["opt"]["m"]), "v": conv(jstate["opt"]["v"]),
                    "step": torch.tensor(int(jstate["opt"]["step"]), dtype=torch.int32)}
    return state


def test_three_train_steps_match_jax(model):
    """Three AdamW steps through `train_step` (fp32 params and moments) on
    three batches, each step of the port started from JAX's state before it
    (so that a rounding difference does not compound through AdamW) and its
    routing pinned to JAX's."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = model["jax"]["f32"]
    kw = dict(lr=3e-4, warmup_steps=1, total_steps=3)
    jopt_cfg, topt_cfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate = {"params": jp, "opt": jax_init_opt_state(jp, jopt_cfg)}
    with mock.patch.object(jax.lax, "top_k", _top_k_spy):
        jstep = jax.jit(jax_train_step, static_argnums=(2, 3))
        for i in range(3):
            batch = MT._batch(10 + i, cfg.vocab_size)
            tstate = _port_state(jstate, cfg, topt_cfg)
            _JAX_CALLS.clear()
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jcfg, jopt_cfg)
            jax.block_until_ready(jm)
            jax.effects_barrier()
            fwd = [torch.from_numpy(c.reshape(-1, cfg.moe.top_k).astype(np.int64))
                   for c, _ in _JAX_CALLS[:len(_moe_layers(cfg))]]
            with CS.RouteRecorder(TL) as rec:
                rec.pin = _recompute_order(fwd, cfg)
                tstate, tm = train_step(tstate, MT._tb(batch), cfg, topt_cfg)
            for key in ("loss", "ce", "ppl", "grad_norm", "lr"):
                np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **TOL_F32,
                                           err_msg=f"step {i} {key}")
            assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == i + 1
            _params_close(tstate, jstate, cfg, float(jm["lr"]), f"step {i}")


def _params_close(tstate, jstate, cfg, lr, what):
    """The first moments (the gradients, averaged) and the params after one
    step elementwise at TOL_F32, but where JAX's first moment lies within
    TOL_F32 x its leaf's largest |value| of 0: there the sign of a rounding
    difference decides AdamW's normalized step (m / (sqrt(v) + eps) is +-1
    at the first step), and the param is held within TOL_F32 + 2 lr."""
    moments = jax.tree_util.tree_leaves(to_jax_params(tstate["opt"]["m"], cfg))
    params = jax.tree_util.tree_leaves(to_jax_params(tstate["params"], cfg))
    for (path, jm), m, (_, jw), w in zip(
            jax.tree_util.tree_leaves_with_path(jstate["opt"]["m"]), moments,
            jax.tree_util.tree_leaves_with_path(jstate["params"]), params):
        name = f"{what} {jax.tree_util.keystr(path)}"
        jm, m, jw, w = _np(jm), _np(m), _np(jw), _np(w)
        np.testing.assert_allclose(m, jm, **TOL_F32, err_msg=name)
        noise = TOL_F32["atol"] * float(np.abs(jm).max())
        atol = np.where(np.abs(jm) > noise, TOL_F32["atol"], TOL_F32["atol"] + 2 * lr)
        assert np.all(np.abs(w - jw) <= atol + TOL_F32["rtol"] * np.abs(jw)), name


def test_trainer_runs_one_period_block_and_its_loss_falls():
    """TrainerConfig.n_layers = 8 keeps one period block (JAX reads a hybrid
    config's depth as n_layers // period blocks); the Trainer trains it on a
    fixed batch on the CPU and the loss falls.  A depth that is not a
    multiple of the period is refused."""
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 32), np.float32)}
    tc = TrainerConfig(arch=ARCH, n_layers=8, steps=4, global_batch=2, seq_len=32,
                       log_every=4, device="cpu")
    tr = Trainer(tc, batches=itertools.repeat(fixed))
    assert tr.cfg == replace(cfg, n_layers=8)
    out = tr.run()
    assert len(tr.state["params"]["blocks"]) == 1
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    with pytest.raises(ValueError, match="multiple of the hybrid period"):
        Trainer(TrainerConfig(arch=ARCH, n_layers=4, device="cpu"))


def test_train_step_runs_the_kernels_chip_smoke_counts(monkeypatch):
    """One loss_fn and its gradients (each period block checkpointed whole, 8
    CE chunks) call each kernel wrapper as often as
    chip_smoke.hybrid_train_launches says a train step launches it; the
    RMSNorm backward takes rows of d_model and of the gated out_norm's
    d_inner (on the card its kernel caps D at 8192, under jamba's d_inner
    16384 at full width)."""
    cfg = CS.hybrid_small_config()
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    want = CS.hybrid_train_launches(cfg)
    calls, widths = dict.fromkeys(want, 0), []

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
    spy(ssd_ops, "ssd_scan", ["ssd_scan"])
    spy(ssd_ops, "ssd_scan_bwd", ["ssd_scan_bwd"])
    spy(ce_ops, "fused_ce", ["fused_ce"])
    spy(ce_ops, "fused_ce_bwd", ["fused_ce_bwd"])
    loss, _ = loss_fn(params, MT._tb(MT._batch(4, cfg.vocab_size)), cfg)
    param_grads(loss, leaves)
    assert calls == want == {"rmsnorm": 47, "rmsnorm_bwd": 24, "flash_attention_fwd": 2,
                             "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
                             "ssd_scan": 14, "ssd_scan_bwd": 7, "fused_ce": 16,
                             "fused_ce_bwd": 8}
    d_inner = cfg.ssm.expand * cfg.d_model
    assert widths.count(d_inner) == 7 and widths.count(cfg.d_model) == 17

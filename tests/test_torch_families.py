"""The last four families of the port against the JAX package, on the CPU:
command-r-35b (tied embeddings, LayerNorm, SwiGLU, vocab 256000 at full
size), starcoder2-15b (LayerNorm, GELU MLP, QKV bias), pixtral-12b (the vit
stub frontend, RMSNorm, rope theta 1e6) and musicgen-large (the encodec
stub frontend, sinusoidal positions, no rope, GELU, LayerNorm).

Each model is reduced (4 layers, d 128, head dim 32, vocab 512) with the
full model's GQA ratio where `reduced()` alone would make it MHA:
command-r 8 query heads over 1 kv head (rep 8, as 64 over 8), starcoder2 12
over 1 (rep 12, as 48 over 4), pixtral 8 over 2 (rep 4, as 32 over 8);
musicgen stays MHA.  Weights from JAX `init_model(cfg, PRNGKey(0))`, carried
across with `repro_torch.convert.from_jax_params`, one module-scoped JAX
reference per arch; inputs from numpy seeds.  On the CPU every kernel
wrapper, and so every autograd op's backward, runs its plain version.

Tolerances are tests/test_torch_serve.py's and tests/test_torch_train.py's:
logits at rtol = atol = 3e-2 with bf16 params and 1e-2 with fp32 params
(the bf16 KV cache is where both sides still round); the loss and every
gradient at 1e-4 with fp32 params, and with bf16 params the loss at 3e-2
and each gradient leaf within 3e-2 of its largest |value|.  The bf16 JAX
references are jitted with `xla_allow_excess_precision` off, so that XLA
rounds every bf16 op as the program states, as the port does.

The stub frontend's embeddings are held bit for bit.  The sinusoidal
positions are bitwise at the reduced width; at musicgen-large's d 2048 XLA's
fp32 exp, sin and cos differ from torch's by an ulp here and there, which
rounds one bf16 ulp apart at a few positions.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch.serve import Server as JaxServer
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import layers as JL
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.launch.serve import Server
from repro_torch.models import decode_step, init_cache, init_model, loss_fn, prefill
from repro_torch.models import layers as TL
from repro_torch.runtime.steps import param_grads
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("command-r-35b", "starcoder2-15b", "pixtral-12b", "musicgen-large")
# reduced() gives 4 heads over min(4, kv) kv heads: MHA for all four; these
# keep each full model's query heads per kv head
GQA = {"command-r-35b": dict(n_heads=8, n_kv_heads=1),
       "starcoder2-15b": dict(n_heads=12, n_kv_heads=1),
       "pixtral-12b": dict(n_heads=8, n_kv_heads=2),
       "musicgen-large": {}}
B, S, MAX_LEN, STEPS = 2, 16, 32, 4
TOL = {"bf16": dict(rtol=3e-2, atol=3e-2), "f32": dict(rtol=1e-2, atol=1e-2)}
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 3e-2
STRICT_BF16 = {"xla_allow_excess_precision": False}
jax_prefill_strict = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
jax_decode_strict = jax.jit(jax_decode_step, static_argnums=(2,), compiler_options=STRICT_BF16)
jax_value_and_grad_strict = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True),
                                    static_argnums=(2,), compiler_options=STRICT_BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_get_config(arch).reduced(**GQA[arch])
    cfg = get_config(arch).reduced(**GQA[arch])
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"arch": arch, "jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32},
            "torch": {d: from_jax_params(_jnp(p), cfg) for d, p in
                      (("bf16", jp), ("f32", jp32))}}


def _embeds(cfg, tokens, dtype):
    """A frontend's `embeds` for `tokens` (the stub table's rows, as the JAX
    Server makes them), as (jax array, torch tensor) in `dtype`; None, None
    for an arch without a frontend."""
    if cfg.frontend is None:
        return None, None
    table = np.random.default_rng(1234).standard_normal(
        (cfg.vocab_size, cfg.d_model), dtype=np.float32) * 0.02
    e = jnp.asarray(table[tokens], jnp.bfloat16).astype(dtype)
    return e, torch.from_numpy(np.array(e.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _batches(cfg, tokens, dtype):
    """The same batch for both sides: tokens, and, with a frontend and bf16
    params, `embeds`.  JAX's `_embed_inputs` casts embeds to bf16, which
    fp32 params cannot take (the fp32 layers' output no longer matches the
    scanned carry), so with fp32 params a frontend arch runs on its tokens,
    as the Trainer feeds it."""
    je, te = _embeds(cfg, tokens, dtype) if dtype == jnp.bfloat16 else (None, None)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.as_tensor(tokens).long()}
    if je is not None:
        jb["embeds"], tb["embeds"] = je, te
    return jb, tb


# ---------------------------------------------------------------------------
# configs, positions, the stub frontend, the converter
# ---------------------------------------------------------------------------

def test_arch_ids_are_jax_arch_ids():
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_matches_jax_full_and_reduced(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    assert asdict(tc) == asdict(jc)
    assert asdict(tc.reduced()) == asdict(jc.reduced())
    assert asdict(tc.reduced(**GQA.get(arch, {}))) == asdict(jc.reduced(**GQA.get(arch, {})))
    assert tc.head_dim == jc.head_dim


@pytest.mark.parametrize("pos0", [0, 37])
def test_sinusoidal_embed_is_jax_bitwise(pos0):
    pos = pos0 + np.arange(64)
    want = np.asarray(JL.sinusoidal_embed(jnp.asarray(pos), 128))
    got = TL.sinusoidal_embed(torch.as_tensor(pos), 128)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (64, 128)
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_sinusoidal_embed_at_musicgen_width_within_one_bf16_ulp():
    """d 2048 at the serve run's positions (0 to 576): apart at few entries,
    each by one bf16 ulp at most, or, where sin or cos is near 0, by less
    than an fp32 ulp of the largest angle (577 rad: 2^-14): XLA's and
    torch's fp32 exp give frequencies an ulp apart, and so angles up to
    577 ulps of a frequency apart."""
    pos = np.arange(577)
    want = np.asarray(JL.sinusoidal_embed(jnp.asarray(pos), 2048).astype(jnp.float32))
    got = TL.sinusoidal_embed(torch.as_tensor(pos), 2048).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= np.maximum(ulp, 2.0 ** -14))
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_embed_stub_is_jax_bitwise(arch):
    """The port's stub table, built once per Server, gives the bits of JAX's
    `_embed_stub` (cast to bf16 as its `generate` does) for a prompt and for
    a decode step's tokens."""
    jsrv, srv = JaxServer(arch), Server(arch, device="cpu")
    vocab = srv.cfg.vocab_size
    for toks in (_tokens(11, (B, S), vocab), _tokens(12, (B, 1), vocab)):
        want = np.asarray(jnp.asarray(jsrv._embed_stub(toks), jnp.bfloat16))
        got = srv._embed_stub(torch.as_tensor(toks).long())
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        assert torch.equal(srv.batch(torch.as_tensor(toks).long())["embeds"], got)
    assert srv._stub.shape == (vocab, srv.cfg.d_model)
    assert Server("starcoder2-15b", device="cpu")._embed_stub(torch.zeros(1, 1).long()) is None


def test_convert_round_trip_keeps_every_leaf(model):
    """JAX params -> the port -> JAX give back every leaf's bits, and the
    port's leaves are those its own `init_model` makes."""
    jp, tp, cfg = _jnp(model["jax"]["bf16"]), model["torch"]["bf16"], model["cfg"]
    back = to_jax_params(tp, cfg)
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, w), (_, g) in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.array_equal(g.view(np.int16), w.view(np.int16)), jax.tree_util.keystr(path)
    own = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == [tuple(t.shape)
                                                          for t in tree_leaves(tp)]
    assert ("head" in tp["embed"]) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# the loss and every gradient
# ---------------------------------------------------------------------------

def _train_batch(cfg, seed):
    """tokens/labels shifted by one and a loss mask with a padded tail, as
    pack_batch makes them; a frontend arch's `embeds` from the stub table."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, 3 * S + 1)).astype(np.int32)
    mask = np.ones((B, 3 * S), np.float32)
    toks[1, 2 * S + 1:] = 0
    mask[1, 2 * S:] = 0.0
    return toks[:, :-1], {"labels": toks[:, 1:], "loss_mask": mask}


def _loss_and_grads(model, dt, seed):
    cfg, jcfg = model["cfg"], model["jcfg"]
    toks, rest = _train_batch(cfg, seed)
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    jb, tb = _batches(cfg, toks, dtype)
    jb.update({k: jnp.asarray(v) for k, v in rest.items()})
    tb.update({"labels": torch.as_tensor(rest["labels"]).long(),
               "loss_mask": torch.as_tensor(rest["loss_mask"])})
    vg = jax_value_and_grad_strict if dt == "bf16" else jax.value_and_grad(jax_loss_fn,
                                                                           has_aux=True)
    (jl, jm), jg = vg(model["jax"][dt], jb, jcfg)
    params = from_jax_params(_jnp(model["jax"][dt]), cfg)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = loss_fn(params, tb, cfg)
    grads = param_grads(loss, leaves)       # the token table is unused beside embeds
    return (jl, jm, jg), (loss, metrics, to_jax_params(tree_unflatten(params, list(grads)), cfg))


def _assert_trees_close(got, want, rel=None, **tol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        if rel is not None:
            tol = dict(rtol=0, atol=rel * max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path), **tol)


def test_loss_and_every_grad_match_jax_f32(model):
    (jl, jm, jg), (loss, metrics, tg) = _loss_and_grads(model, "f32", 1)
    for key in ("loss", "ce", "aux", "ppl"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    _assert_trees_close(tg, jg, **TOL_F32)


def test_loss_and_every_grad_match_jax_bf16(model):
    (jl, jm, jg), (loss, metrics, tg) = _loss_and_grads(model, "bf16", 2)
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    assert all(leaf.dtype.name == "bfloat16" for leaf in jax.tree_util.tree_leaves(tg))
    _assert_trees_close(tg, jg, rel=TOL_BF16)


# ---------------------------------------------------------------------------
# serving: prefill and decode, Server.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_prefill_and_teacher_forced_decode_match_jax(model, dt):
    """Prefill logits of [2, 16] prompts (with bf16 params, through the stub
    frontend's embeds for pixtral and musicgen), then 4 decode steps fed the
    same tokens (and embeds) on both sides, each step's logits and the final
    cache compared."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    toks = _tokens(6, (B, S + STEPS), cfg.vocab_size)
    jb, tb = _batches(cfg, toks[:, :S], dtype)
    prefill_fn = jax_prefill_strict if dt == "bf16" else jax.jit(jax_prefill, static_argnums=(2,))
    decode_fn = (jax_decode_strict if dt == "bf16"
                 else jax.jit(jax_decode_step, static_argnums=(2,)))
    jl, jc = prefill_fn(jp, jb, jcfg, jax_init_cache(jcfg, B, MAX_LEN))
    with torch.inference_mode():
        tl, tc = prefill(tp, tb, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dt])
    for i in range(STEPS):
        jb, tb = _batches(cfg, toks[:, S + i:S + i + 1], dtype)
        jl, jc = decode_fn(jp, jb, jcfg, jc, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = decode_step(tp, tb, cfg, tc, S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dt], err_msg=f"step {i}")
    np.testing.assert_allclose(_np(tc["kv"]["k"]), _np(jc["kv"]["k"]), **TOL[dt])


def test_server_generate_matches_jax_where_the_argmax_is_clear(model):
    """Greedy tokens of the port's Server (CPU, converted weights, the stub
    frontend's table built once) equal the JAX Server's (which rebuilds the
    table every call) up to the first step whose JAX top-1 margin is within
    the bf16 tolerance of both logits (there either pick is right)."""
    arch, jcfg, cfg = model["arch"], model["jcfg"], model["cfg"]
    jp, tp = model["jax"]["bf16"], model["torch"]["bf16"]
    n = 6
    prompts = _tokens(8, (B, S), cfg.vocab_size)
    jsrv = JaxServer(arch, max_len=MAX_LEN, params=jp)
    jsrv.cfg = jcfg                 # the GQA override; the jitted steps read it
    srv = Server(arch, max_len=MAX_LEN, params=tp, device="cpu")
    srv.cfg = cfg
    jout, tout = jsrv.generate(prompts, n), srv.generate(prompts, n)
    assert tout["tokens"].shape == (B, n) and tout["finite"]
    # JAX logits along the JAX tokens give each step's margin
    seq = np.concatenate([prompts, jout["tokens"]], axis=1)

    def jbatch(t):
        b = {"tokens": jnp.asarray(t)}
        emb = jsrv._embed_stub(t)
        if emb is not None:
            b["embeds"] = jnp.asarray(emb, jnp.bfloat16)
        return b

    lg, c = jsrv._prefill(jp, jax_init_cache(jcfg, B, MAX_LEN), jbatch(prompts))
    margins = []
    for i in range(n):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0] - 2 * (3e-2 + 3e-2 * np.abs(top2[:, 1])))
        lg, c = jsrv._decode(jp, c, jbatch(seq[:, S + i:S + i + 1]), jnp.int32(S + i))
    margins = np.stack(margins, 1)
    checked = 0
    for b in range(B):
        unclear = np.nonzero(margins[b] <= 0)[0]
        upto = unclear[0] if len(unclear) else n
        np.testing.assert_array_equal(tout["tokens"][b, :upto], jout["tokens"][b, :upto])
        checked += upto
    assert checked >= 1


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's two smoke tests, ported, over every arch
# ---------------------------------------------------------------------------

SMOKE_B, SMOKE_S = 2, 64


def _smoke_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_S))),
             "loss_mask": torch.ones((SMOKE_B, SMOKE_S))}
    if cfg.frontend is not None:
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (SMOKE_B, SMOKE_S, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
        batch["tokens"] = torch.zeros((SMOKE_B, SMOKE_S), dtype=torch.long)  # unused
    else:
        batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                       (SMOKE_B, SMOKE_S)))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = get_config(arch).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = loss_fn(params, _smoke_batch(cfg, 1), cfg)
    assert loss.shape == () and torch.isfinite(loss), f"{arch}: loss not finite"
    assert float(metrics["ce"].detach()) > 0
    grads = param_grads(loss, leaves)
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    assert torch.isfinite(gnorm) and float(gnorm) > 0, f"{arch}: grad norm {gnorm}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_smoke(arch):
    cfg = get_config(arch).reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _smoke_batch(cfg, 1)
    with torch.inference_mode():
        cache = init_cache(cfg, SMOKE_B, 96, "cpu")
        logits, cache = prefill(params, batch, cfg, cache)
        assert tuple(logits.shape) == (SMOKE_B, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all(), f"{arch}: prefill NaN"
        step = {k: v[:, :1] for k, v in batch.items()}
        logits2, cache = decode_step(params, step, cfg, cache, SMOKE_S)
    assert tuple(logits2.shape) == (SMOKE_B, 1, cfg.vocab_size)
    assert torch.isfinite(logits2).all(), f"{arch}: decode NaN"


def test_sinusoidal_positions_start_at_the_cache_position():
    """musicgen's decode step adds the position of its cache slot: a step at
    position p gives the logits of the last row of a prefill of p + 1 rows
    (the same embeds), as JAX's `_model_step` passes pos0 = cache_pos."""
    cfg = get_config("musicgen-large").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((1, 9, cfg.d_model), dtype=np.float32) * 0.02)
    toks = torch.zeros((1, 9), dtype=torch.long)
    with torch.inference_mode():
        full, _ = prefill(params, {"tokens": toks, "embeds": emb}, cfg,
                          init_cache(cfg, 1, 16, "cpu"))
        _, c = prefill(params, {"tokens": toks[:, :8], "embeds": emb[:, :8]}, cfg,
                       init_cache(cfg, 1, 16, "cpu"))
        step, _ = decode_step(params, {"tokens": toks[:, 8:], "embeds": emb[:, 8:]}, cfg, c, 8)
    np.testing.assert_allclose(_np(step), _np(full), **TOL["bf16"])

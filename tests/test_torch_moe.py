"""The port's MoE serve path (MLA attention, capacity-routed MoE, the dense
prefix layers) against the JAX package, on the CPU.

Reduced deepseek-v2-lite-16b (softmax router, no q compression; 4 layers,
the first dense, d 128, 8 experts top-2, kv_lora 64, rope 16) and reduced
deepseek-v3-671b (sigmoid router with `router_bias` and `router_scale`
2.5, the q-LoRA branch with its `q_norm`, the MTP head's params): weights
from JAX `init_model(cfg, PRNGKey(0))`, carried across with
`repro_torch.convert.from_jax_params`, inputs from numpy seeds.  On the CPU
every kernel wrapper runs its plain version.

Routing is held exactly.  JAX's `top_idx` is read from its `jax.lax.top_k`
call; `keep` and the slot of every route follow from `top_idx` by the
semantics (routes numbered token-major, then by j, fill each expert's
`capacity` slots in that order), computed here by a plain loop.  The
router's fp32 products sum in another order on each side, so a token whose
k-th and (k+1)-th selection scores lie within NEAR_TIE of each other may
rank them the other way: such tokens are left out of the exact comparison
(and printed), as are the routes their flip could move.

Tolerances: bf16 params at rtol = atol = 3e-2 (tests/test_kernels.py's
TOL_BF16), params cast to fp32 at 1e-2, as tests/test_torch_serve.py; the
aux loss at rtol 1e-5 (fp32 sums).  The whole-model JAX references are
jitted with `xla_allow_excess_precision` off, as in tests/test_torch_serve.py.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
from dataclasses import asdict, replace
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
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.launch.serve import Server
from repro_torch.models import decode_step, forward, init_cache, init_model, loss_fn, prefill
from repro_torch.models import layers as TL

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
B, S, MAX_LEN = 2, 16, 32
TOL = {"bf16": dict(rtol=3e-2, atol=3e-2), "f32": dict(rtol=1e-2, atol=1e-2)}
NEAR_TIE = 1e-5
STRICT_BF16 = {"xla_allow_excess_precision": False}
jax_prefill_strict = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
jax_decode_strict = jax.jit(jax_decode_step, static_argnums=(2,),
                            compiler_options=STRICT_BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(tokens):
    return torch.as_tensor(tokens, dtype=torch.long)


def _with_router_bias(jp, cfg, seed):
    """deepseek-v3's `router_bias` is 0 at init; a nonzero one (the same on
    both sides) makes selection differ from weighting, as after training."""
    if cfg.moe.router != "sigmoid":
        return jp
    bias = np.random.default_rng(seed).normal(0.0, 0.05, jp["blocks"]["ffn"]["router_bias"].shape)
    blocks = dict(jp["blocks"], ffn=dict(jp["blocks"]["ffn"],
                                         router_bias=jnp.asarray(bias, jnp.float32)))
    return dict(jp, blocks=blocks)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp = _with_router_bias(jp, jcfg, 11)
    # fp32 everywhere (the router's leaves already are)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {
        "arch": arch, "jcfg": jcfg, "cfg": cfg,
        "jax": {"bf16": jp, "f32": jp32},
        "torch": {d: from_jax_params(jax.tree_util.tree_map(np.asarray, p), cfg)
                  for d, p in (("bf16", jp), ("f32", jp32))},
    }


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_config_values_and_reduced_match_jax(arch, full):
    jc, tc = jax_get_config(arch), get_config(arch)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    assert asdict(tc) == asdict(jc)


def test_converter_round_trip_keeps_prefix_blocks_mtp_and_fp32_router(model):
    """JAX -> port -> JAX gives every leaf back bit for bit; the dense prefix
    is a list of unstacked layers on both sides, the MoE blocks one dict a
    layer in the port, and the router leaves stay fp32."""
    jp, tp, cfg = model["jax"]["bf16"], model["torch"]["bf16"], model["cfg"]
    n_prefix = cfg.moe.n_dense_prefix
    assert isinstance(tp["prefix"], list) and len(tp["prefix"]) == n_prefix >= 1
    assert len(tp["blocks"]) == cfg.n_layers - n_prefix
    assert "router" not in tp["prefix"][0]["ffn"]
    ffn = tp["blocks"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["wi_gate"].shape) == (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert_ff)
    assert ("router_bias" in ffn) == (cfg.moe.router == "sigmoid")
    assert ("mtp" in tp) == cfg.mtp
    back = to_jax_params(tp, cfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
    bleaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(jleaves) == len(bleaves)
    for path, a in jleaves:
        b = bleaves[path]
        assert b.dtype == a.dtype and b.shape == a.shape, jax.tree_util.keystr(path)
        assert np.array_equal(b.view(np.uint8), a.view(np.uint8)), jax.tree_util.keystr(path)
    assert back["blocks"]["ffn"]["router"].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_matches_jax_structure_and_dtypes(arch):
    """The port's own init has JAX's leaves: names, shapes and dtypes."""
    cfg = get_config(arch).reduced()
    p = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp, _ = jax_init_model(jax_get_config(arch).reduced(), jax.random.PRNGKey(0))
    got = {jax.tree_util.keystr(k): (v.shape, v.dtype)
           for k, v in jax.tree_util.tree_leaves_with_path(to_jax_params(p, cfg))}
    want = {jax.tree_util.keystr(k): (tuple(v.shape), np.dtype(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    assert got == want
    wg = p["blocks"][0]["ffn"]["wi_gate"].float()
    assert abs(wg.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.01
    c = init_cache(cfg, 2, 8, "cpu")
    assert set(c) == {"mla"} and tuple(c["mla"]["ckv"].shape) == (
        cfg.n_layers, 2, 8, cfg.mla.kv_lora_rank)


# ---------------------------------------------------------------------------
# MoE: routing, dispatch, combine
# ---------------------------------------------------------------------------

def _moe_input(case, d, dtype):
    """'tokens': B x S tokens of N(0, 1); 'drops': 4 tokens close to one
    another, so that they pick the same experts and overflow capacity 2."""
    rng = np.random.default_rng(21)
    if case == "tokens":
        x = rng.standard_normal((B, S, d))
    else:
        x = rng.standard_normal((1, 1, d)) + 0.05 * rng.standard_normal((1, 4, d))
    return jnp.asarray(x, dtype)


def _jax_moe(jp, x, jcfg):
    """JAX's apply_moe, with what its top_k call saw and returned."""
    seen = {}
    real_top_k = jax.lax.top_k

    def spy(a, k):
        vals, idx = real_top_k(a, k)
        seen["sel_scores"], seen["top_idx"] = np.asarray(a), np.asarray(idx)
        return vals, idx
    with mock.patch.object(jax.lax, "top_k", spy):
        y, aux = JL.apply_moe(jp, x, jcfg)
    return y, aux, seen


def _slots(top_idx, n_experts, capacity):
    """keep and slot of every route: routes token-major, then by j, fill
    their expert's capacity slots in that order; a route past it is dropped
    and sits at slot capacity - 1."""
    fill = np.zeros(n_experts, np.int64)
    keep = np.zeros(top_idx.shape, bool)
    pos = np.zeros(top_idx.shape, np.int64)
    for i in range(top_idx.shape[0]):
        for j in range(top_idx.shape[1]):
            e = top_idx[i, j]
            keep[i, j], pos[i, j] = fill[e] < capacity, min(fill[e], capacity - 1)
            fill[e] += 1
    return keep, pos


def _near_ties(sel_scores, k):
    """Tokens whose k-th and (k+1)-th largest selection scores lie within
    NEAR_TIE."""
    top = -np.sort(-sel_scores, axis=-1)
    return (top[:, k - 1] - top[:, k]) < NEAR_TIE


@pytest.mark.parametrize("case", ["tokens", "drops"])
def test_moe_routing_and_drops_match_jax_exactly(model, case):
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"]["bf16"]["blocks"]["ffn"])
    tp = model["torch"]["bf16"]["blocks"][0]["ffn"]
    x = _moe_input(case, cfg.d_model, jnp.bfloat16)
    _, _, seen = _jax_moe(jp, x, jcfg)
    mo = cfg.moe
    t = x.shape[0] * x.shape[1]
    capacity = int(max(1, np.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor)))
    with torch.inference_mode():
        _, top_idx, _ = TL.moe_route(tp, to_tensor(x).reshape(t, -1), cfg)
        counts, keep, pos = TL.moe_slots(top_idx, mo.n_experts, capacity)
    top_idx, keep, pos = top_idx.numpy(), keep.numpy(), pos.numpy()
    j_idx = seen["top_idx"]
    near = _near_ties(seen["sel_scores"], mo.top_k)
    flipped = near & (top_idx != j_idx).any(1)
    print(f"{model['arch']} {case}: {int(near.sum())} of {t} tokens within "
          f"{NEAR_TIE} of a tie left out, {int(flipped.sum())} flipped")
    np.testing.assert_array_equal(top_idx[~near], j_idx[~near])
    # keep and pos follow the port's own top_idx exactly, and JAX's wherever
    # no flipped token's experts are involved
    want_keep, want_pos = _slots(top_idx, mo.n_experts, capacity)
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(top_idx.ravel(),
                                                              minlength=mo.n_experts))
    j_keep, _ = _slots(j_idx, mo.n_experts, capacity)
    moved = np.isin(j_idx, np.concatenate([j_idx[flipped].ravel(), top_idx[flipped].ravel()]))
    same = ~flipped[:, None] & ~moved
    np.testing.assert_array_equal(keep[same], j_keep[same])
    if case == "drops":
        assert capacity == 2 and not j_keep.all()


@pytest.mark.parametrize("case", ["tokens", "drops"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_apply_moe_matches_jax(model, case, dt):
    """y and the aux loss of one MoE layer (routed experts, the shared
    experts, capacity drops)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"][dt]["blocks"]["ffn"])
    tp = model["torch"][dt]["blocks"][0]["ffn"]
    x = _moe_input(case, cfg.d_model, jnp.bfloat16 if dt == "bf16" else jnp.float32)
    jy, jaux, seen = _jax_moe(jp, x, jcfg)
    assert not _near_ties(seen["sel_scores"], cfg.moe.top_k).any()
    with torch.inference_mode():
        ty, taux = TL.apply_moe(tp, to_tensor(x), cfg)
    assert ty.dtype == to_tensor(x).dtype and ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dt])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_apply_moe_gives_every_token_all_its_experts_at_full_capacity(model):
    """With capacity_factor = n_experts / top_k no route drops: each token's
    output is its k experts' outputs, weighted, plus the shared experts."""
    cfg = replace(model["cfg"], moe=replace(model["cfg"].moe, capacity_factor=4.0))
    p = model["torch"]["f32"]["blocks"][0]["ffn"]
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((1, 6, cfg.d_model))
                         ).float()
    with torch.inference_mode():
        y, _ = TL.apply_moe(p, x, cfg)
        _, top_idx, top_w = TL.moe_route(p, x[0], cfg)
        want = TL.apply_mlp(p["shared"], x, cfg)[0]
        for i in range(6):
            for j in range(cfg.moe.top_k):
                e = int(top_idx[i, j])
                ep = {"wi_gate": p["wi_gate"][e], "wi_up": p["wi_up"][e], "wo": p["wo"][e]}
                want[i] += top_w[i, j] * TL.apply_mlp(ep, x[:, i:i + 1], cfg)[0, 0]
    np.testing.assert_allclose(_np(y[0]), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# MLA: the absorbed (cache) branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "chunked_prefill", "decode"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_mla_fwd_matches_jax(model, mode, dt):
    """The cache branch at cache_pos 0 with 16 rows, at 8 with 8 new rows and
    at 16 with one row (a decode step), in the first MoE layer; the cache
    contents too."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"][dt]["blocks"]["attn"])
    tp = model["torch"][dt]["blocks"][0]["attn"]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    rng = np.random.default_rng(3)
    pos, s = {"prefill": (0, S), "chunked_prefill": (8, 8), "decode": (16, 1)}[mode]
    x = jnp.asarray(rng.standard_normal((B, s, cfg.d_model)), dtype)
    positions = pos + np.arange(s)
    m = cfg.mla
    live = (np.arange(MAX_LEN) < pos)[None, :, None]        # rows already cached
    jc = {"ckv": jnp.asarray(rng.standard_normal((B, MAX_LEN, m.kv_lora_rank)) * live,
                             jnp.bfloat16),
          "krope": jnp.asarray(rng.standard_normal((B, MAX_LEN, m.qk_rope_dim)) * live,
                               jnp.bfloat16)}
    tc = {k: to_tensor(v) for k, v in jc.items()}
    jy, jc = JL.mla_fwd(jp, x, jcfg, jnp.asarray(positions), kv_cache=jc,
                        cache_pos=jnp.int32(pos))
    with torch.inference_mode():
        ty, tc2 = TL.mla_fwd(tp, to_tensor(x), cfg, torch.as_tensor(positions), kv_cache=tc,
                             cache_pos=pos)
    assert tc2 is tc                                         # written in place
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dt])
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL[dt])


def test_mla_without_a_cache_is_the_train_path_and_raises(model):
    """Without a cache MLA runs its expanded branch (the train path: K and V
    expanded from the latent, attention over [nope | rope] through the flash
    op) and matches JAX's no-cache branch; it no longer raises.  (The name
    dates from when it raised; tests/test_torch_moe_train.py holds the branch
    with gradients.)"""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], model["jax"]["bf16"]["blocks"]["attn"])
    tp = model["torch"]["bf16"]["blocks"][0]["attn"]
    x = jnp.asarray(np.random.default_rng(8).standard_normal((B, S, cfg.d_model)), jnp.bfloat16)
    jy, jc = JL.mla_fwd(jp, x, jcfg, jnp.arange(S))
    with torch.inference_mode():
        ty, tc = TL.mla_fwd(tp, to_tensor(x), cfg, torch.arange(S))
    assert tc is None and jc is None
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL["bf16"])


# ---------------------------------------------------------------------------
# the slice: prefill, decode, Server.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_prefill_and_teacher_forced_decode_match_jax(model, dt):
    """Prefill logits of [2, 16] prompts, then 8 decode steps fed the same
    tokens on both sides, each step's logits and the final latent cache."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S + 8)).astype(np.int32)
    jl, jc = jax_prefill_strict(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                                jax_init_cache(jcfg, B, MAX_LEN))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": _t(toks[:, :S])}, cfg,
                         init_cache(cfg, B, MAX_LEN, "cpu"))
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dt])
    for i in range(8):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jax_decode_strict(jp, {"tokens": jnp.asarray(step)}, jcfg, jc,
                                   jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = decode_step(tp, {"tokens": _t(step)}, cfg, tc, S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dt], err_msg=f"step {i}")
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc["mla"][key]), _np(jc["mla"][key]), **TOL[dt])


def test_prefill_then_decode_matches_longer_prefill_at_full_capacity(model):
    """The port against itself, as chip_smoke.py's cross_check_moe: the last
    logits of a 17-token prefill and of a 16-token prefill plus one decode
    step, with capacity_factor = n_experts / top_k so that no route drops
    (tests/test_arch_smoke.py gives the JAX model the same for the same
    equivalence: at the served factor, per-step routing drops by design)."""
    cfg = model["cfg"]
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tp = model["torch"]["bf16"]
    toks = _t(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 1)))
    with torch.inference_mode():
        full, _ = prefill(tp, {"tokens": toks}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        _, c = prefill(tp, {"tokens": toks[:, :S]}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        step, _ = decode_step(tp, {"tokens": toks[:, S:]}, cfg, c, S)
    assert (step - full).abs().max() <= 3e-2 * full.abs().max()


def test_server_serves_moe_on_cpu_and_defaults_to_cuda(model):
    arch = model["arch"]
    a = Server(arch, max_len=24, device="cpu", seed=1)
    b = Server(arch, max_len=24, device="cpu", seed=1)
    assert torch.equal(a.params["blocks"][0]["ffn"]["wo"], b.params["blocks"][0]["ffn"]["wo"])
    prompts = np.random.default_rng(9).integers(0, a.cfg.vocab_size, (B, 8)).astype(np.int32)
    out = a.generate(prompts, 4)
    assert out["tokens"].shape == (B, 4) and out["finite"]
    np.testing.assert_array_equal(out["tokens"], b.generate(prompts, 4)["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Server(arch)


def test_moe_training_raises_naming_its_roadmap_item(model):
    """Both MoE models train now (ROADMAP Queue 1 item 1 is done):
    deepseek-v2-lite-16b's loss is finite with its aux loss, and
    deepseek-v3-671b's also carries the MTP head's mtp_ce, added to the loss
    at 0.1 as JAX's loss_fn adds it (tests/test_torch_v3_train.py holds it
    to JAX).  The hybrid family trains too (test below)."""
    cfg, tp = model["cfg"], model["torch"]["bf16"]
    toks = _t(np.zeros((1, 8)))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        loss, metrics = loss_fn(tp, batch, cfg)
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    assert ("mtp_ce" in metrics) == cfg.mtp
    if cfg.mtp:
        assert torch.isfinite(metrics["mtp_ce"])
        want = metrics["ce"].float() + 0.01 * metrics["aux"] + 0.1 * metrics["mtp_ce"]
        assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_hybrid_training_still_raises_naming_its_roadmap_item(model):
    """The hybrid family trains now (ROADMAP Queue 1 item 3 is done; the name
    is kept from when it was refused): reduced jamba-1.5-large-398b with this
    arch's MoE config (the softmax router, or the sigmoid one with its
    router_bias and a shared expert) in its period block's four MoE layers:
    forward and loss_fn run, and report a positive aux loss, the sum over
    the block's MoE layers (tests/test_torch_hybrid.py holds the family to
    JAX)."""
    cfg = replace(get_config("jamba-1.5-large-398b").reduced(), moe=model["cfg"].moe)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    ffn = params["blocks"][0]["layers"][1]["ffn"]
    assert ("router_bias" in ffn) == (cfg.moe.router == "sigmoid")
    toks = _t(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 8)))
    with torch.no_grad():
        h, aux = forward(params, {"tokens": toks}, cfg)
        loss, metrics = loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    assert h.shape == (1, 8, cfg.d_model) and torch.isfinite(h).all()
    assert float(aux) > 0 and float(metrics["aux"]) == pytest.approx(float(aux))
    assert torch.isfinite(loss) and "mtp_ce" not in metrics


# ---------------------------------------------------------------------------
# the RMSNorm at a row pitch (kv_norm reads a slice of the projection)
# ---------------------------------------------------------------------------

def test_rmsnorm_plain_version_of_a_strided_slice_matches_jax():
    """kv_norm's input: the first 64 columns of [B, S, 80] rows (reduced;
    512 of 576 at full width), normalised as JAX normalises the slice."""
    rng = np.random.default_rng(4)
    full = jnp.asarray(rng.standard_normal((B, S, 80)) * 3, jnp.bfloat16)
    scale = jnp.asarray(1 + 0.1 * rng.standard_normal(64), jnp.bfloat16)
    x = to_tensor(full)[..., :64]
    assert not x.is_contiguous() and rms_kernel.row_pitch(x) == 80
    out = TL.apply_norm({"scale": to_tensor(scale)}, x)
    np.testing.assert_allclose(_np(out), _np(JL.apply_norm({"scale": scale}, full[..., :64])),
                               **TOL["bf16"])


class _LooksCuda(torch.Tensor):
    """A CPU tensor that answers is_cuda = True (the C entry point is faked)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("shape,cols,pitch", [((2, 16, 576), 512, 576), ((4, 1, 576), 512, 576),
                                              ((3, 64), 64, 64), ((2, 5, 24), 16, 24)])
def test_rmsnorm_wrapper_hands_the_kernel_the_rows_in_place(monkeypatch, shape, cols, pitch):
    """On a CUDA tensor the wrapper passes the slice's own data pointer and
    its row pitch (one launch, no copy), and allocates a contiguous output."""
    calls = []

    def function(name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return call
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    base = torch.Tensor._make_subclass(_LooksCuda, torch.randn(*shape).to(torch.bfloat16))
    x = base[..., :cols]
    scale = torch.Tensor._make_subclass(_LooksCuda, torch.ones(cols, dtype=torch.bfloat16))
    out = rms_kernel.rmsnorm(x, scale)
    [(name, args)] = calls
    rows = int(np.prod(shape[:-1]))
    assert name == "rmsnorm_bf16" and args[0] == x.data_ptr() == base.data_ptr()
    assert args[3:6] == (rows, cols, pitch)
    assert out.is_contiguous() and out.shape == x.shape


def test_rmsnorm_wrapper_refuses_rows_at_no_uniform_pitch():
    x = torch.zeros(4, 3, 576, dtype=torch.bfloat16)[:, :2, :512]   # rows 576 and 1152 apart
    with pytest.raises(ValueError, match="uniform pitch"):
        rms_kernel.row_pitch(x)
    assert rms_kernel.row_pitch(x[:, :1]) == 3 * 576


# ---------------------------------------------------------------------------
# chip_smoke.py's cross_check_moe: flips are allowed only at near-ties
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gap,wide", [(2e-2, True), (1.5e-2, True), (5e-3, False),
                                      (2.5e-3, False)])
def test_cross_check_moe_fails_a_flip_at_a_wide_gap(gap, wide):
    """Two recorded runs of one MoE layer, 3 tokens of top-2 routes: token 1
    takes experts {1, 3} in one and {1, 2} in the other, its 2nd and 3rd
    scores `gap` apart in one run (half of it in the other).  `route_flips`
    finds that one flip; `wide_flips`, whose non-empty result fails the
    chip_smoke.py gate, holds it iff a gap reaches NEAR_TIE (1e-2)."""
    cs = _chip_smoke()
    idx = torch.tensor([[0, 1], [1, 3], [2, 0]])
    a = {"idx": idx, "gap": torch.tensor([0.3, gap / 2, 0.2])}
    b = {"idx": torch.tensor([[1, 0], [2, 1], [2, 0]]), "gap": torch.tensor([0.3, gap, 0.2])}
    flips = cs.route_flips([a], [b])
    assert [(f["layer"], f["token"]) for f in flips] == [(0, 1)]
    assert cs.NEAR_TIE == 1e-2
    assert bool(cs.wide_flips(flips)) == wide
    assert cs.wide_flips(cs.route_flips([a], [a])) == []

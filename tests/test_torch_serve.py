"""The port's serve path against the JAX package, on the CPU.

Reduced chatglm3-6b (4 layers, d 128, 4 heads, kv 2, dh 32, vocab 512):
weights from JAX `init_model(cfg, PRNGKey(0))`, carried across with
`repro_torch.convert.from_jax_params`, inputs from a numpy seed.  On the CPU
every kernel wrapper runs its plain version.

Tolerances: bf16 params at rtol = atol = 3e-2 (tests/test_kernels.py's
TOL_BF16); params cast to fp32 on both sides at 1e-2, where the bf16 KV
cache (layers.py:203-206) is the one place both sides still round.

The whole-model JAX references are jitted with XLA's
`xla_allow_excess_precision` off, so that XLA rounds every bf16 op as the
program states, as the port does.  With XLA's default it keeps some fused
bf16 intermediates in fp32; the two sides then round at different places and
the logits differ by up to 0.047 (on logits of magnitude ~3.7), with 1 of
1024 logits 0.0036 past the bound at the prefill and at one of 8 decode
steps.  Strict, the largest difference is 0.031 and every logit is inside.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import itertools
from dataclasses import asdict, fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jax_get_config
from repro.launch.serve import Server as JaxServer
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.launch.serve import Server, main
from repro_torch.models import decode_step, forward, init_cache, init_model, loss_fn, prefill
from repro_torch.models import layers as TL

ARCH = "chatglm3-6b"
B, S, MAX_LEN = 2, 16, 32
TOL = {"bf16": dict(rtol=3e-2, atol=3e-2), "f32": dict(rtol=1e-2, atol=1e-2)}
STRICT_BF16 = {"xla_allow_excess_precision": False}
jax_prefill_strict = jax.jit(jax_prefill, static_argnums=(2,),
                             compiler_options=STRICT_BF16)
jax_decode_strict = jax.jit(jax_decode_step, static_argnums=(2,),
                            compiler_options=STRICT_BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {
        "jcfg": jcfg, "cfg": cfg,
        "jax": {"bf16": jp, "f32": jp32},
        "torch": {d: from_jax_params(jax.tree_util.tree_map(np.asarray, p), cfg)
                  for d, p in (("bf16", jp), ("f32", jp32))},
    }


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(tokens):
    return torch.as_tensor(tokens, dtype=torch.long)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MoEConfig", "MLAConfig", "SSMConfig",
                                  "HybridConfig", "ModelConfig"])
def test_config_schema_is_a_copy_of_jax(name):
    jf = [(f.name, f.default) for f in fields(getattr(jbase, name))]
    tf = [(f.name, f.default) for f in fields(getattr(tbase, name))]
    assert tf == jf


def test_config_values_and_reduced_match_jax():
    for arch, full in itertools.product((ARCH, "mamba2-130m"), (False, True)):
        jc, tc = jax_get_config(arch), get_config(arch)
        if not full:
            jc, tc = jc.reduced(), tc.reduced()
        assert asdict(tc) == asdict(jc)
        assert tc.head_dim == jc.head_dim
    # command-r-35b, the case that raised before its config was copied
    assert asdict(get_config("command-r-35b")) == asdict(jax_get_config("command-r-35b"))
    with pytest.raises(KeyError):
        get_config("command-r-36b")            # no such arch


def test_convert_keeps_names_layouts_and_bits(model):
    jp, tp, cfg = model["jax"]["bf16"], model["torch"]["bf16"], model["cfg"]
    assert len(tp["blocks"]) == cfg.n_layers
    assert set(tp["blocks"][0]) == set(jp["blocks"]) == {"attn_norm", "attn", "ffn_norm", "ffn"}
    assert set(tp["blocks"][0]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    for i in (0, cfg.n_layers - 1):
        for key in ("wq", "wo", "bk"):
            j = np.asarray(jp["blocks"]["attn"][key][i])
            t = tp["blocks"][i]["attn"][key]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            assert np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
    assert np.array_equal(_np(tp["embed"]["head"]), _np(jp["embed"]["head"]))


def test_init_model_matches_jax_structure_and_distributions():
    cfg = get_config(ARCH).reduced()
    p = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp, _ = jax_init_model(jax_get_config(ARCH).reduced(), jax.random.PRNGKey(0))
    assert p["blocks"][0]["attn"]["wq"].shape == jp["blocks"]["attn"]["wq"].shape[1:]
    assert p["embed"]["head"].shape == jp["embed"]["head"].shape
    wq = p["blocks"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert torch.all(p["blocks"][0]["attn"]["bq"] == 0)
    assert torch.all(p["final_norm"]["scale"] == 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["rms", "layer"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_apply_norm_matches_jax(branch, dt):
    rng = np.random.default_rng(1)
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((B, S, 128)) * 3, dtype)
    p = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(128), dtype)}
    if branch == "layer":
        p["bias"] = jnp.asarray(0.1 * rng.standard_normal(128), dtype)
    out = TL.apply_norm({k: to_tensor(v) for k, v in p.items()}, to_tensor(x))
    np.testing.assert_allclose(_np(out), _np(JL.apply_norm(p, x)), **TOL[dt])


@pytest.mark.parametrize("fraction", [0.5, 1.0])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_apply_rope_matches_jax(fraction, dt):
    rng = np.random.default_rng(2)
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((B, S, 4, 32)) * 2, dtype)
    pos = np.arange(S, dtype=np.int32) + 37
    out = TL.apply_rope(to_tensor(x), torch.as_tensor(pos), 10000.0, fraction)
    ref = JL.apply_rope(x, jnp.asarray(pos), 10000.0, fraction)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dt])


@pytest.mark.parametrize("mode", ["nocache", "prefill", "chunked_prefill", "decode"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_attention_fwd_matches_jax(model, mode, dt):
    """The no-cache branch, the cache branch at pos 0 (flash), at pos 8 with
    8 new rows (flash with q_offset) and at pos 16 with one row (decode);
    the cache contents are compared too."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[1], model["jax"][dt]["blocks"]["attn"])
    tp = model["torch"][dt]["blocks"][1]["attn"]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), dtype)
    pos, s = {"nocache": (0, S), "prefill": (0, S), "chunked_prefill": (8, 8),
              "decode": (16, 1)}[mode]
    x = x[:, :s]
    positions = pos + np.arange(s)
    if mode == "nocache":
        jy, _ = JL.attention_fwd(jp, x, jcfg, jnp.asarray(positions))
        ty, _ = TL.attention_fwd(tp, to_tensor(x), cfg, torch.as_tensor(positions))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dt])
        return
    # a cache already holding `pos` rows, the same on both sides
    prior = (rng.standard_normal((B, MAX_LEN, cfg.n_kv_heads, cfg.head_dim))
             * (np.arange(MAX_LEN) < pos)[None, :, None, None])
    jc = {"k": jnp.asarray(prior, jnp.bfloat16), "v": jnp.asarray(prior * 0.5, jnp.bfloat16)}
    tc = {k: to_tensor(v) for k, v in jc.items()}
    jy, jc = JL.attention_fwd(jp, x, jcfg, jnp.asarray(positions), kv_cache=jc,
                              cache_pos=jnp.int32(pos))
    ty, tc = TL.attention_fwd(tp, to_tensor(x), cfg, torch.as_tensor(positions),
                              kv_cache=tc, cache_pos=pos)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dt])
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL[dt])


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_apply_mlp_matches_jax(act, dt):
    jcfg = replace(jax_get_config(ARCH).reduced(), act=act)
    cfg = replace(get_config(ARCH).reduced(), act=act)
    jp, _ = JL.init_mlp(jcfg, jax.random.PRNGKey(4))
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((B, S, 128)), dtype)
    out = TL.apply_mlp({k: to_tensor(v) for k, v in jp.items()}, to_tensor(x), cfg)
    np.testing.assert_allclose(_np(out), _np(JL.apply_mlp(jp, x, jcfg)), **TOL[dt])


# ---------------------------------------------------------------------------
# the slice: prefill, decode, Server.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_prefill_and_teacher_forced_decode_match_jax(model, dt):
    """Prefill logits of [2, 16] prompts, then 8 decode steps fed the same
    tokens on both sides, each step's logits and the final cache compared."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    toks = _tokens(6, (B, S + 8), cfg.vocab_size)
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
    np.testing.assert_allclose(_np(tc["kv"]["k"]), _np(jc["kv"]["k"]), **TOL[dt])


def test_prefill_then_decode_matches_longer_prefill(model):
    """The port against itself: the last logits of a 17-token prefill and of
    a 16-token prefill plus one decode step (flash vs decode kernel paths).
    chip_smoke.py holds the full-width model to the same bound, measured
    against the logits' largest magnitude (see ROADMAP Queue 3)."""
    cfg, tp = model["cfg"], model["torch"]["bf16"]
    toks = _t(_tokens(7, (B, S + 1), cfg.vocab_size))
    with torch.inference_mode():
        full, _ = prefill(tp, {"tokens": toks}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        _, c = prefill(tp, {"tokens": toks[:, :S]}, cfg, init_cache(cfg, B, MAX_LEN, "cpu"))
        step, _ = decode_step(tp, {"tokens": toks[:, S:]}, cfg, c, S)
    np.testing.assert_allclose(_np(step), _np(full), **TOL["bf16"])
    assert (step - full).abs().max() <= 3e-2 * full.abs().max()


def test_server_generate_matches_jax_where_the_argmax_is_clear(model):
    """Greedy tokens of the port's Server (CPU, converted weights) equal the
    JAX Server's up to the first step whose JAX top-1 margin is within the
    bf16 tolerance of both logits (there either pick is right)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"]["bf16"], model["torch"]["bf16"]
    prompts = _tokens(8, (B, S), cfg.vocab_size)
    n = 8
    jout = JaxServer(ARCH, max_len=MAX_LEN, params=jp).generate(prompts, n)
    tout = Server(ARCH, max_len=MAX_LEN, params=tp, device="cpu").generate(prompts, n)
    assert tout["tokens"].shape == (B, n) and tout["finite"]
    assert set(tout) >= set(jout)
    # JAX logits along the JAX tokens (jitted as the JAX Server jits them)
    # give each step's margin
    seq = np.concatenate([prompts, jout["tokens"]], axis=1)
    jprefill = jax.jit(jax_prefill, static_argnums=(2,))
    jdecode = jax.jit(jax_decode_step, static_argnums=(2,))
    lg, c = jprefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg,
                     jax_init_cache(jcfg, B, MAX_LEN))
    margins = []
    for i in range(n):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0] - 2 * (3e-2 + 3e-2 * np.abs(top2[:, 1])))
        lg, c = jdecode(jp, {"tokens": jnp.asarray(seq[:, S + i:S + i + 1])},
                        jcfg, c, jnp.int32(S + i))
    margins = np.stack(margins, 1)
    checked = 0
    for b in range(B):
        unclear = np.nonzero(margins[b] <= 0)[0]
        upto = unclear[0] if len(unclear) else n
        np.testing.assert_array_equal(tout["tokens"][b, :upto], jout["tokens"][b, :upto])
        checked += upto
    assert checked >= 1


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_server_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tokens", "1"])


def test_server_seeded_init_and_generate_on_cpu():
    a = Server(ARCH, max_len=24, device="cpu", seed=1)
    b = Server(ARCH, max_len=24, device="cpu", seed=1)
    assert torch.equal(a.params["blocks"][2]["ffn"]["wo"], b.params["blocks"][2]["ffn"]["wo"])
    prompts = _tokens(9, (B, 8), a.cfg.vocab_size)
    out = a.generate(prompts, 4)
    assert out["tokens"].shape == (B, 4) and out["finite"]
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0
    np.testing.assert_array_equal(out["tokens"], b.generate(prompts, 4)["tokens"])
    with pytest.raises(ValueError):
        a.generate(prompts, 17)                # 8 + 17 > max_len 24


def test_serve_main_runs_on_cpu(capsys):
    main(["--device", "cpu", "--batch", "2", "--prompt-len", "4", "--tokens", "2"])
    assert "[serve] arch=chatglm3-6b device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("change,item", [
    # the hybrid family this case refused is ported (tests/test_torch_hybrid.py),
    # and so is the stub frontend it took next (tests/test_torch_families.py);
    # its id stays
    pytest.param(dict(frontend="encodec"), "trains", id="change0-Queue 1 item 3"),
    (dict(moe=tbase.MoEConfig(n_experts=4, top_k=2)), "trains"),
    (dict(mla=tbase.MLAConfig(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                              v_head_dim=32)), "trains"),
    # the roadmap item MTP training closed stays in its id
    pytest.param(dict(mtp=True), "trains",
                 id="change3-Queue 1 item 1, deepseek-v3-671b training"),
    # sinusoidal positions are ported (tests/test_torch_families.py); the id stays
    pytest.param(dict(pos_embed="sinusoidal"), "trains", id="change4-Queue 1 item 4"),
])
def test_unported_branches_name_their_roadmap_item(change, item):
    """Every branch a config can name now runs (item "trains": forward and
    loss_fn run, and loss_fn reports the MTP head's mtp_ce): MoE, MLA and
    MTP (tests/test_torch_moe.py, tests/test_torch_moe_train.py and
    tests/test_torch_v3_train.py hold them to JAX), a stub frontend (fed
    tokens here, as the Trainer feeds it) and sinusoidal positions
    (tests/test_torch_families.py)."""
    cfg = replace(get_config(ARCH).reduced(), **change)
    if item == "trains":
        params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        init_cache(cfg, 1, 8, "cpu")
        toks = torch.zeros((1, 8), dtype=torch.long)
        for fn in (forward, loss_fn):
            with torch.no_grad():
                out = fn(params, {"tokens": toks, "labels": toks}, cfg)
            assert torch.isfinite(out[0]).all()
        assert ("mtp_ce" in out[1]) == cfg.mtp
        return
    with pytest.raises(NotImplementedError, match=item):
        init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match=item):
        init_cache(cfg, 1, 8, "cpu")

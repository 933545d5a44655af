"""The port's Mamba2 (ssm) serve path against the JAX package, on the CPU.

Reduced mamba2-130m (4 layers, d 128, d_inner 256, 8 SSD heads of dim 32,
d_state 32, conv width 4, chunk 32, vocab 512, tied embeddings): weights
from JAX `init_model(cfg, PRNGKey(0))`, carried across with
`repro_torch.convert.from_jax_params`, inputs from numpy seeds.  On the CPU
the SSD-scan and RMSNorm wrappers run their plain versions.

Tolerances, each with its reason:
* the plain SSD scan against JAX `ssd_chunked` and the Pallas kernel in
  interpret mode: 5e-3 in fp32 (tests/test_kernels.py's), TOL_BF16 =
  3e-2 for bf16 inputs (the Pallas kernel writes y in bf16);
* `_causal_conv`: bitwise in bf16 (the same products, rounded and summed
  in the same order);
* `ssm_fwd` (one layer): rtol = atol = 3e-2 with bf16 params (TOL_BF16),
  1e-3 with fp32 params;
* the whole model with fp32 params: 1e-3 elementwise (only the order of
  fp32 sums differs: the port's prompt goes through the chunked scan, JAX's
  through the per-token recurrence); the conv state, a bf16 cache on both
  sides of activations that agree to 1e-3, to one bf16 ulp (rtol 2^-7,
  atol 1e-3), and the scan state, which such an ulp of a cached conv input
  moves, at 1e-2;
* the whole model with bf16 params: the relative L2 error of each step's
  logits and of the states <= 3e-2 (TOL_BF16, the gate chip_smoke.py's
  train_check uses).  The fp32 sums that differ in order are rounded to
  bf16 before the gated norm, so a value lands one bf16 ulp apart now and
  then, and four random layers amplify such a flip until single logits
  pass rtol = atol = 3e-2 elementwise, while the logits as a whole stay
  close.  Where no value flips the two sides agree bit for bit.

The whole-model JAX references are jitted with XLA's
`xla_allow_excess_precision` off, as in tests/test_torch_serve.py, so that
XLA rounds every bf16 op as the program states, as the port does.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_kernel
from repro.launch.serve import Server as JaxServer
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_tensor
from repro_torch.kernels import ssd_scan, ssd_scan_ref
from repro_torch.launch.serve import Server, main
from repro_torch.models import decode_step, init_cache, init_model, prefill
from repro_torch.models import ssm as TS

ARCH = "mamba2-130m"
B, S = 2, 64
TOL = {"bf16": dict(rtol=3e-2, atol=3e-2), "f32": dict(rtol=1e-3, atol=1e-3)}
TOL_SCAN = dict(rtol=5e-3, atol=5e-3)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
STRICT_BF16 = {"xla_allow_excess_precision": False}
jax_prefill_strict = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
jax_decode_strict = jax.jit(jax_decode_step, static_argnums=(2,),
                            compiler_options=STRICT_BF16)
DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(tokens):
    return torch.as_tensor(tokens, dtype=torch.long)


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


def _scan_inputs(seed, b, s, h, p, n, dtype=np.float32, h0=False):
    """x, dt (softplus'd), a_log, B, C and optionally h0, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32).astype(dtype)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a_log = rng.standard_normal(h, dtype=np.float32) * 0.1
    Bm = rng.standard_normal((b, s, n), dtype=np.float32).astype(dtype)
    Cm = rng.standard_normal((b, s, n), dtype=np.float32).astype(dtype)
    out = [x, dt, a_log, Bm, Cm]
    if h0:
        out.append(rng.standard_normal((b, h, p, n), dtype=np.float32))
    return out


def _torch_scan(args, chunk, h0=None):
    x, dt, a_log, Bm, Cm = (to_tensor(a) for a in args)
    return ssd_scan(x, dt, a_log, Bm, Cm, chunk=chunk,
                    h0=None if h0 is None else to_tensor(h0))


# ---------------------------------------------------------------------------
# the SSD scan: plain version against JAX ssd_chunked and the Pallas kernel
# ---------------------------------------------------------------------------

SCAN_SHAPES = [(1, 32, 4, 16, 16, 8), (2, 64, 8, 16, 32, 16), (1, 64, 8, 32, 64, 32),
               (2, 128, 2, 8, 16, 64)]          # tests/test_kernels.py:94-99


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_ssd_scan_ref_matches_jax_ssd_chunked(b, s, h, p, n, chunk, with_h0):
    args = _scan_inputs(0, b, s, h, p, n, h0=with_h0)
    h0 = args.pop() if with_h0 else None
    y, hf = _torch_scan(args, chunk, h0)
    yr, hr = JS.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    assert y.dtype == hf.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **TOL_SCAN)
    np.testing.assert_allclose(_np(hf), _np(hr), **TOL_SCAN)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_ssd_scan_ref_matches_pallas_kernel(b, s, h, p, n, chunk):
    args = _scan_inputs(1, b, s, h, p, n)
    y, hf = _torch_scan(args, chunk)
    yk, hk = jax_ssd_kernel(*(jnp.asarray(a) for a in args), chunk=chunk,
                            heads_block=min(4, h), interpret=True)
    np.testing.assert_allclose(_np(y), _np(yk), **TOL_SCAN)
    np.testing.assert_allclose(_np(hf), _np(hk), **TOL_SCAN)


def test_ssd_scan_ref_bf16_inputs_match_pallas_kernel():
    args = _scan_inputs(7, 1, 32, 4, 16, 16, dtype=jnp.bfloat16)
    y, _ = _torch_scan(args, 8)
    yk, _ = jax_ssd_kernel(*(jnp.asarray(a) for a in args), chunk=8, heads_block=2,
                           interpret=True)
    assert yk.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(y), _np(yk), **TOL_BF16)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_ref_tail_matches_ssd_chunked(with_h0):
    """S = 40 with chunk 32: padded to 64 with zeros, against ssd_chunked at
    chunk 8, which divides 40."""
    args = _scan_inputs(2, 2, 40, 4, 16, 32, h0=with_h0)
    h0 = args.pop() if with_h0 else None
    y, hf = _torch_scan(args, 32, h0)
    yr, hr = JS.ssd_chunked(*(jnp.asarray(a) for a in args), 8,
                            h0=None if h0 is None else jnp.asarray(h0))
    assert tuple(y.shape) == (2, 40, 4, 16)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL_SCAN)
    np.testing.assert_allclose(_np(hf), _np(hr), **TOL_SCAN)


def test_ssd_scan_ref_strong_decay_is_finite():
    """a_log = log 16, dt up to 3: the in-chunk cumsum falls below -10^3,
    where exp(-cum) is inf in fp32; the masked exponent keeps y finite."""
    x, dt, _, Bm, Cm = _scan_inputs(3, 1, 256, 2, 16, 16)
    dt = np.minimum(dt * 3, 3.0).astype(np.float32)
    a_log = np.full(2, np.log(16.0), np.float32)
    y, hf = _torch_scan([x, dt, a_log, Bm, Cm], 256)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    yr, hr = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, Bm, Cm)), 256)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL_SCAN)


def test_ssd_scan_raises_on_an_input_that_requires_grad():
    x, dt, a_log, Bm, Cm = (to_tensor(a) for a in _scan_inputs(4, 1, 8, 2, 16, 16))
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ssd_scan_op"):
        ssd_scan(x, dt, a_log, Bm, Cm, chunk=8)
    with torch.no_grad():
        y, _ = ssd_scan(x, dt, a_log, Bm, Cm, chunk=8)
    yr, _ = ssd_scan_ref(x.detach(), dt, a_log, Bm, Cm, chunk=8)
    assert torch.equal(y, yr)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["plain", "h0", "strong_h0"])
def test_chip_smoke_fp64_recurrence_matches_ssd_chunked(case):
    """`chip_smoke.ssd_scan_f64`, the fp64 one-row-at-a-time recurrence the
    SSD kernel's relative-L2 gate is measured against, computes the same
    function as JAX `ssd_chunked` and the port's plain version (S = 40, not
    a multiple of their chunk 16, from a state, under strong decay).  The
    other two sum in fp32: TOL_SCAN."""
    args = _scan_inputs(5, 2, 40, 4, 16, 32, h0=True)
    h0 = args.pop() * ("h0" in case)
    if "strong" in case:
        args[1] = np.minimum(args[1] * 3, 3.0).astype(np.float32)
        args[2] = np.full(4, np.log(16.0), np.float32)
    y64, h64 = _chip_smoke().ssd_scan_f64(*(to_tensor(a) for a in args), to_tensor(h0))
    assert y64.dtype == h64.dtype == torch.float64
    yr, hr = JS.ssd_chunked(*(jnp.asarray(a) for a in args[:3]),
                            *(jnp.asarray(a) for a in args[3:]), 8, h0=jnp.asarray(h0))
    yt, ht = ssd_scan_ref(*(to_tensor(a) for a in args), chunk=16, h0=to_tensor(h0))
    for got, want in ((y64, yr), (h64, hr), (y64, yt), (h64, ht)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL_SCAN)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 7, 16])
def test_causal_conv_is_bitwise_jax(s, with_state):
    rng = np.random.default_rng(5)
    xbc = jnp.asarray(rng.standard_normal((B, s, 320)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 320)) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(320) * 0.1, jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((B, 3, 320)), jnp.bfloat16) if with_state else None
    jy, jst = JS._causal_conv(xbc, w, b, st)
    ty, tst = TS._causal_conv(to_tensor(xbc), to_tensor(w), to_tensor(b),
                              None if st is None else to_tensor(st))
    assert ty.dtype == tst.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.view(torch.int16).numpy(),
                                  np.asarray(jy).view(np.int16))
    np.testing.assert_array_equal(tst.view(torch.int16).numpy(),
                                  np.asarray(jst).view(np.int16))


@pytest.mark.parametrize("mode", ["nostate", "prompt", "decode"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_ssm_fwd_matches_jax(model, mode, dt):
    """No state (JAX: ssd_chunked), a state and 24 new rows (JAX: the
    recurrence; the port: the scan from h0), a state and one row (both the
    recurrence); the new conv and scan states are compared too."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[1], model["jax"][dt]["blocks"]["ssm"])
    tp = model["torch"][dt]["blocks"][1]["ssm"]
    rng = np.random.default_rng(6)
    s = {"nostate": S, "prompt": 24, "decode": 1}[mode]
    x = jnp.asarray(rng.standard_normal((B, s, cfg.d_model)), DTYPES[dt])
    dm = TS.ssm_dims(cfg)
    if mode == "nostate":
        jst = tst = None
    else:
        conv = rng.standard_normal((B, dm["d_conv"] - 1, dm["conv_dim"]))
        h = rng.standard_normal((B, dm["n_heads"], dm["head_dim"], dm["d_state"])) * 0.3
        jst = {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(h, jnp.float32)}
        tst = {k: to_tensor(v) for k, v in jst.items()}
    jy, jnew = JS.ssm_fwd(jp, x, jcfg, state=jst)
    with torch.inference_mode():
        ty, tnew = TS.ssm_fwd(tp, to_tensor(x), cfg, state=tst)
    assert ty.dtype == tp["out_proj"].dtype
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dt])
    np.testing.assert_allclose(_np(tnew["ssm"]), _np(jnew["ssm"]), **TOL[dt])
    np.testing.assert_allclose(_np(tnew["conv"]), _np(jnew["conv"]), **TOL[dt])


# ---------------------------------------------------------------------------
# configs, weights and the converter
# ---------------------------------------------------------------------------

def test_config_values_match_jax():
    for full in (False, True):
        jc, tc = jax_get_config(ARCH), get_config(ARCH)
        if not full:
            jc, tc = jc.reduced(), tc.reduced()
        assert asdict(tc) == asdict(jc)
    assert TS.ssm_dims(get_config(ARCH)) == JS.ssm_dims(jax_get_config(ARCH))


def test_convert_round_trips_ssm_params_bit_for_bit(model):
    jp, tp, cfg = model["jax"]["bf16"], model["torch"]["bf16"], model["cfg"]
    assert set(tp["embed"]) == {"tok"}                 # tied: no head
    assert set(tp["blocks"][0]) == {"norm", "ssm"}
    assert set(tp["blocks"][0]["ssm"]) == {"in_proj", "conv_w", "conv_b", "A_log", "D",
                                           "dt_bias", "out_norm", "out_proj"}
    for key in ("A_log", "D", "dt_bias"):
        assert tp["blocks"][0]["ssm"][key].dtype == torch.float32
    back = to_jax_params(tp, cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        got = flat_b[path]
        assert got.dtype == a.dtype and got.shape == a.shape, jax.tree_util.keystr(path)
        assert a.tobytes() == got.tobytes(), jax.tree_util.keystr(path)


def test_init_model_and_cache_match_jax_structure():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    p = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    for key, j in jp["blocks"]["ssm"].items():
        t = p["blocks"][0]["ssm"][key]
        assert tuple(t.shape) == j.shape[1:], key
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), key
    np.testing.assert_allclose(_np(p["blocks"][0]["ssm"]["A_log"]),
                               _np(jp["blocks"]["ssm"]["A_log"][0]), rtol=1e-6)
    w = p["blocks"][0]["ssm"]["in_proj"].float()
    assert abs(w.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert set(p["embed"]) == {"tok"}
    c, jc = init_cache(cfg, B, 99, "cpu"), jax_init_cache(jcfg, B, 99)
    for key in ("conv", "ssm"):
        t, j = c["ssm_state"][key], jc["ssm_state"][key]
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert not t.any()


def test_tied_lm_logits_read_the_token_embedding(model):
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    cfg, jcfg = model["cfg"], model["jcfg"]
    h = jnp.asarray(np.random.default_rng(9).standard_normal((B, 3, cfg.d_model)),
                    jnp.bfloat16)
    tl = TL.lm_logits(model["torch"]["bf16"]["embed"], to_tensor(h), cfg)
    jl = JL.lm_logits(model["jax"]["bf16"]["embed"], h, jcfg)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 3, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["bf16"])


# ---------------------------------------------------------------------------
# the slice: prefill, decode, Server.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [S, 40])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_prefill_and_teacher_forced_decode_match_jax(model, dt, s):
    """Prefill logits of [2, s] prompts (s = 40 is not a multiple of the
    chunk), then 8 decode steps fed the same tokens on both sides, each
    step's logits and the final states compared."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    toks = _tokens(10, (B, s + 8), cfg.vocab_size)
    jl, jc = jax_prefill_strict(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg,
                                jax_init_cache(jcfg, B, s + 8))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": _t(toks[:, :s])}, cfg,
                         init_cache(cfg, B, s + 8, "cpu"))
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _model_close(tl, jl, dt, "prefill")
    for i in range(8):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jax_decode_strict(jp, {"tokens": jnp.asarray(step)}, jcfg, jc,
                                   jnp.int32(s + i))
        with torch.inference_mode():
            tl, tc = decode_step(tp, {"tokens": _t(step)}, cfg, tc, s + i)
        _model_close(tl, jl, dt, f"step {i}")
    _model_close(tc["ssm_state"]["ssm"], jc["ssm_state"]["ssm"], dt, "ssm state",
                 dict(rtol=1e-2, atol=1e-2))
    _model_close(tc["ssm_state"]["conv"], jc["ssm_state"]["conv"], dt, "conv state",
                 dict(rtol=2.0 ** -7, atol=1e-3))


def _model_close(got, want, dt, what, f32_tol=TOL["f32"]):
    """The whole-model bounds of the module docstring."""
    got, want = _np(got), _np(want)
    if dt == "f32":
        np.testing.assert_allclose(got, want, **f32_tol, err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, f"{what}: relative L2 error {rel}"


@pytest.mark.parametrize("s", [S, 40])
def test_prefill_then_decode_matches_longer_prefill(model, s):
    """The port against itself: the last logits of an (s+1)-token prefill
    (the scan over every row) and of an s-token prefill plus one decode step
    (the scan's final state, then the recurrence), at the bound
    chip_smoke.py holds the full-width model to."""
    cfg, tp = model["cfg"], model["torch"]["bf16"]
    toks = _t(_tokens(11, (B, s + 1), cfg.vocab_size))
    with torch.inference_mode():
        full, _ = prefill(tp, {"tokens": toks}, cfg, init_cache(cfg, B, 0, "cpu"))
        _, c = prefill(tp, {"tokens": toks[:, :s]}, cfg, init_cache(cfg, B, 0, "cpu"))
        step, _ = decode_step(tp, {"tokens": toks[:, s:]}, cfg, c, s)
    np.testing.assert_allclose(_np(step), _np(full), **TOL["bf16"])
    assert (step - full).abs().max() <= 3e-2 * full.abs().max()


def test_server_generate_matches_jax_where_the_argmax_is_clear(model):
    """Greedy tokens of the port's Server (CPU, converted weights) equal the
    JAX Server's up to the first step whose JAX top-1 margin is within the
    bf16 tolerance of both logits (there either pick is right)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"]["bf16"], model["torch"]["bf16"]
    prompts = _tokens(12, (B, 24), cfg.vocab_size)
    n = 8
    jout = JaxServer(ARCH, max_len=64, params=jp).generate(prompts, n)
    tout = Server(ARCH, max_len=64, params=tp, device="cpu").generate(prompts, n)
    assert tout["tokens"].shape == (B, n) and tout["finite"]
    seq = np.concatenate([prompts, jout["tokens"]], axis=1)
    jprefill = jax.jit(jax_prefill, static_argnums=(2,))
    jdecode = jax.jit(jax_decode_step, static_argnums=(2,))
    lg, c = jprefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg, jax_init_cache(jcfg, B, 64))
    margins = []
    for i in range(n):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0] - 2 * (3e-2 + 3e-2 * np.abs(top2[:, 1])))
        lg, c = jdecode(jp, {"tokens": jnp.asarray(seq[:, 24 + i:25 + i])}, jcfg, c,
                        jnp.int32(24 + i))
    margins = np.stack(margins, 1)
    checked = 0
    for b in range(B):
        unclear = np.nonzero(margins[b] <= 0)[0]
        upto = unclear[0] if len(unclear) else n
        np.testing.assert_array_equal(tout["tokens"][b, :upto], jout["tokens"][b, :upto])
        checked += upto
    assert checked >= 1


def test_serve_main_runs_mamba2_on_cpu(capsys):
    main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "5",
          "--tokens", "2"])
    assert f"[serve] arch={ARCH} device=cpu" in capsys.readouterr().out


def test_server_mamba2_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ARCH)

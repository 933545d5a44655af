"""The port's Mamba2 (ssm) train path against the JAX package, on the CPU.

The SSD scan's gradient: `ssd_scan_bwd_ref` (the plain version of the
backward kernel, explicit chunked formulas) against `jax.vjp` of
`repro/models/ssm.py::ssd_chunked` (what JAX trains through) and against
torch autograd of `ssd_scan_ref`; `ssd_scan_op` (the autograd op) against
`ssd_scan_bwd_ref`.  Then reduced mamba2-130m (4 layers, d 128, 8 SSD heads
of dim 32, d_state 32, chunk 32, vocab 512, tied embeddings): weights from
JAX `init_model(cfg, PRNGKey(0))` carried across with
`repro_torch.convert.from_jax_params`, batches from a numpy seed with padded
(masked) tails.  On the CPU every kernel wrapper runs its plain version.

Tolerances, each with its reason:
* the scan's gradients in fp32: within 5e-3 of each gradient's largest
  |value| (the forward tests' fp32 tolerance, tests/test_kernels.py); a
  gradient that is 0 in exact arithmetic (its computed value is noise)
  within 5e-3 of the largest |value| of the case's other gradients;
* `ssd_scan_op`: bitwise `ssd_scan_bwd_ref` (the op calls it);
* `loss_fn` with fp32 params: TOL_F32 = 1e-4 on the loss and per gradient
  leaf, as tests/test_torch_train.py (only the order of fp32 sums differs);
* with bf16 params: the loss at TOL_BF16 = 3e-2, and the relative L2 error
  of all gradients together <= 3e-2, each leaf's reported.  A per-leaf
  bf16 gate is unsafe here: values rounded to bf16 from fp32 sums taken in
  another order land one ulp apart now and then (tests/test_torch_ssm.py's
  docstring), and four random layers amplify such a flip in single leaves.
The bf16 JAX reference is jitted with `xla_allow_excess_precision` off, as
in tests/test_torch_train.py.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import itertools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models.ssm import ssd_chunked
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.runtime.steps import train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_op, ssd_scan_ref
from repro_torch.launch.train import Trainer, TrainerConfig, main
from repro_torch.models import forward, loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_state, train_step
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "mamba2-130m"
B, S = 2, 64                     # S a multiple of the reduced chunk (32): ssd_chunked asserts it
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 3e-2
TOL_SCAN = 5e-3
STRICT_BF16 = {"xla_allow_excess_precision": False}
NAMES = ("dx", "ddt", "da_log", "dB", "dC", "dh0")

jax_value_and_grad_strict = jax.jit(
    jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(2,),
    compiler_options=STRICT_BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scan_case(seed, b, s, h, p, n):
    """x, dt (softplus'd), a_log, B, C, h0 and the cotangents dy, dh_final,
    as fp32 numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)
    x, dt = normal(b, s, h, p), np.log1p(np.exp(normal(b, s, h))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return (x, dt, a_log, normal(b, s, n), normal(b, s, n), normal(b, h, p, n, scale=0.3),
            normal(b, s, h, p), normal(b, h, p, n))


def _close_to_max(got, want, tol, what, scale=None):
    """Within tol x the largest |want|, as tests/test_torch_train.py's
    relative bound.  A gradient that is 0 in exact arithmetic has no scale of
    its own (its computed value is rounding noise on one side): the caller
    passes `scale`, the largest |value| of the case's other gradients."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ---------------------------------------------------------------------------
# the SSD scan's gradient
# ---------------------------------------------------------------------------

BWD_SHAPES = [(1, 32, 4, 16, 16, 8), (2, 64, 8, 16, 32, 16), (1, 64, 8, 32, 64, 32),
              (2, 128, 2, 8, 16, 64), (2, 96, 3, 16, 32, 32)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", BWD_SHAPES)
def test_ssd_scan_bwd_ref_matches_jax_vjp_of_ssd_chunked(b, s, h, p, n, chunk, with_h0):
    """Cotangents on both y and h_final; without h0 JAX starts from zeros."""
    x, dt, a_log, Bm, Cm, h0, dy, dhf = _scan_case(0, b, s, h, p, n)
    h0 = h0 if with_h0 else np.zeros_like(h0)
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:5], chunk, h0=a[5]),
                     *(jnp.asarray(a) for a in (x, dt, a_log, Bm, Cm, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    t = torch.from_numpy
    got = ssd_scan_bwd_ref(t(x), t(dt), t(a_log), t(Bm), t(Cm), t(h0) if with_h0 else None,
                           t(dy), t(dhf), chunk=chunk)
    assert (got[5] is None) == (not with_h0)
    for name, g, w in zip(NAMES, got, want):
        if g is not None:
            assert g.dtype == torch.float32
            _close_to_max(g, w, TOL_SCAN, name)


@pytest.mark.parametrize("case", ["tail", "tail_h0", "one_row", "dy_only", "dh_final_only",
                                  "strong_decay"])
def test_ssd_scan_bwd_ref_matches_autograd_of_ssd_scan_ref(case):
    """S = 45 and 1 (not a multiple of the chunk 16: padded with dt = 0),
    a cotangent on one output only, and a_log = log 16 with dt up to 3
    (exp(-cum) would be inf in fp32; no exponent above the diagonal is
    formed)."""
    s = {"one_row": 1}.get(case, 45)
    x, dt, a_log, Bm, Cm, h0, dy, dhf = (torch.from_numpy(a)
                                         for a in _scan_case(1, 2, s, 3, 16, 32))
    if case == "strong_decay":
        dt, a_log = torch.clamp(dt * 3, max=3.0), torch.full((3,), float(np.log(16.0)))
    h0 = h0 if "h0" in case else None
    dy = None if case == "dh_final_only" else dy
    dhf = None if case == "dy_only" else dhf
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a_log, Bm, Cm)]
    h0l = None if h0 is None else h0.clone().requires_grad_(True)
    y, hf = ssd_scan_ref(*leaves, chunk=16, h0=h0l)
    loss = sum((o * g).sum() for o, g in ((y, dy), (hf, dhf)) if g is not None)
    inputs = leaves + ([h0l] if h0l is not None else [])
    want = torch.autograd.grad(loss, inputs, allow_unused=True)    # h_final does not read C
    got = ssd_scan_bwd_ref(x, dt, a_log, Bm, Cm, h0, torch.zeros(x.shape) if dy is None else dy,
                           dhf, chunk=16)
    # 0 in exact arithmetic: da_log of one row, which no decay reaches (no
    # exponent of the scan differs from 0), and dC when only h_final, which
    # does not read C, has a cotangent
    zero = {"one_row": "da_log", "dh_final_only": "dC"}.get(case)
    others = max(float(w.abs().max()) for nm, w in zip(NAMES, want)
                 if w is not None and nm != zero)
    for name, g, w, t in zip(NAMES, got, want, inputs):
        w = torch.zeros_like(t) if w is None else w
        assert torch.isfinite(g).all(), name
        _close_to_max(g, w, TOL_SCAN, name, scale=others if name == zero else None)
    assert (got[5] is None) == (h0 is None)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_op_gradients_are_ssd_scan_bwd_ref_bitwise(with_h0, dtype):
    """The autograd op's forward is `ssd_scan` and its backward
    `ssd_scan_bwd` (on the CPU, their plain versions): the same bits, and
    each gradient in its input's dtype (bf16 x, B and C, as the model
    passes them)."""
    x, dt, a_log, Bm, Cm, h0, dy, dhf = (torch.from_numpy(a)
                                         for a in _scan_case(2, 2, 40, 4, 16, 32))
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a_log, Bm, Cm)]
    h0l = None if h0 is None else h0.clone().requires_grad_(True)
    y, hf = ssd_scan_op(*leaves, chunk=16, h0=h0l)
    yr, hr = ssd_scan_ref(x, dt, a_log, Bm, Cm, chunk=16, h0=h0)
    assert torch.equal(y.detach(), yr) and torch.equal(hf.detach(), hr)
    got = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(),
                              leaves + ([h0l] if h0l is not None else []))
    want = ssd_scan_bwd_ref(x, dt, a_log, Bm, Cm, h0, dy, dhf, chunk=16)
    for name, g, w, leaf in zip(NAMES, got, want, leaves + [h0l]):
        assert g.dtype == leaf.dtype, name
        assert torch.equal(g, w), name


def test_ssd_scan_op_with_only_y_used_passes_no_dh_final():
    """The train path drops h_final: autograd hands the op no gradient for
    it, and the backward reads it as zeros."""
    x, dt, a_log, Bm, Cm, _, dy, _ = (torch.from_numpy(a) for a in _scan_case(3, 1, 32, 2, 16, 16))
    xl = x.clone().requires_grad_(True)
    y, _ = ssd_scan_op(xl, dt, a_log, Bm, Cm, chunk=16)
    (gx,) = torch.autograd.grad((y * dy).sum(), [xl])
    assert torch.equal(gx, ssd_scan_bwd_ref(x, dt, a_log, Bm, Cm, None, dy, None, chunk=16)[0])


def test_ssd_scan_op_under_inference_mode_is_the_scan():
    args = [torch.from_numpy(a) for a in _scan_case(4, 1, 20, 2, 16, 16)[:5]]
    with torch.inference_mode():
        y, hf = ssd_scan_op(*args, chunk=16)
    yr, hr = ssd_scan_ref(*args, chunk=16)
    assert torch.equal(y, yr) and torch.equal(hf, hr)


def test_ssd_scan_bwd_wrapper_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _scan_case(5, 1, 33, 2, 16, 16)]
    x, dt, a_log, Bm, Cm, h0, dy, dhf = args
    got = ssd_scan_bwd(x, dt, a_log, Bm, Cm, h0, dy, dhf, chunk=16)
    want = ssd_scan_bwd_ref(x, dt, a_log, Bm, Cm, h0, dy, dhf, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the model: loss_fn and every gradient against JAX value_and_grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
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
    return {"tokens": torch.as_tensor(batch["tokens"]).long(),
            "labels": torch.as_tensor(batch["labels"]).long(),
            "loss_mask": torch.as_tensor(batch["loss_mask"])}


def _grads(params, batch, cfg):
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = loss_fn(params, _tb(batch), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, to_jax_params(tree_unflatten(params, list(grads)), cfg)


def _leaves(got, want):
    """(name, got, want) of every leaf, numpy fp32, JAX layout."""
    return [(jax.tree_util.keystr(path), _np(g), _np(w)) for (path, w), g in
            zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got))]


def test_loss_and_every_grad_match_jax_f32(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = _batch(1, cfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        model["jax"]["f32"], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, tg = _grads(_torch_params(model, "f32"), batch, cfg)
    for key in ("loss", "ce", "aux", "ppl"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    leaves = _leaves(tg, jg)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jg)) == 11
    for name, g, w in leaves:
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL_F32)


def test_loss_and_every_grad_match_jax_bf16(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = _batch(2, cfg.vocab_size)
    (jl, jm), jg = jax_value_and_grad_strict(
        model["jax"]["bf16"], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, tg = _grads(_torch_params(model, "bf16"), batch, cfg)
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["ppl"]), _np(jm["ppl"]), rtol=TOL_BF16)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg), tree_leaves(tg)):
        assert g.dtype == w.dtype, jax.tree_util.keystr(path)
    leaves = _leaves(tg, jg)
    per_leaf = {name: float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))
                for name, g, w in leaves}
    rel = float(np.linalg.norm(np.concatenate([(g - w).ravel() for _, g, w in leaves]))
                / np.linalg.norm(np.concatenate([w.ravel() for _, _, w in leaves])))
    print("relative L2 error of all gradients", rel, "per leaf", per_leaf)
    assert rel <= TOL_BF16, per_leaf


def test_remat_changes_nothing(model):
    cfg = model["cfg"]
    batch = _batch(3, cfg.vocab_size)
    out = {}
    for remat in ("layer", "none"):
        loss, _, g = _grads(_torch_params(model, "f32"), batch, replace(cfg, remat=remat))
        out[remat] = (loss, g)
    assert float(out["layer"][0].detach()) == float(out["none"][0].detach())
    for name, a, b in _leaves(out["layer"][1], out["none"][1]):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_forward_runs_each_layer_from_no_state(model):
    """forward's ssm branch: the hidden state of JAX's forward (each layer
    through ssd_chunked from zeros), fp32 params."""
    from repro.models import forward as jax_forward
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = _batch(4, cfg.vocab_size)
    jh, jaux = jax_forward(model["jax"]["f32"], {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
    with torch.no_grad():
        th, aux = forward(_torch_params(model, "f32"), _tb(batch), cfg)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np(th), _np(jh), **TOL_F32)


# ---------------------------------------------------------------------------
# train_step and the Trainer
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp = model["jax"]["f32"]
    kw = dict(lr=3e-4, warmup_steps=1, total_steps=3)
    jopt_cfg, topt_cfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate = {"params": jp, "opt": jax_init_opt_state(jp, jopt_cfg)}
    tstate = make_train_state(cfg, topt_cfg, params=from_jax_params(_jnp(jp), cfg))
    jstep = jax.jit(jax_train_step, static_argnums=(2, 3))
    for i in range(3):
        batch = _batch(10 + i, cfg.vocab_size)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jcfg, jopt_cfg)
        tstate, tm = train_step(tstate, _tb(batch), cfg, topt_cfg)
        for key in ("loss", "ce", "ppl", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **TOL_F32)
        for name, g, w in _leaves(to_jax_params(tstate["params"], cfg), jstate["params"]):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL_F32)


def test_fixed_batch_repeated_is_learnable_by_the_trainer():
    """chip_smoke.py's train_ssm phase on the CPU, at the reduced size: one
    fixed batch repeated, fp32 moments; the loss falls."""
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 65)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 64), np.float32)}
    tc = TrainerConfig(arch=ARCH, steps=4, global_batch=2, seq_len=64, device="cpu")
    out = Trainer(tc, batches=itertools.repeat(fixed)).run()
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]


def test_train_main_runs_mamba2_on_cpu(capsys):
    main(["--device", "cpu", "--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16"])
    assert "[trainer] done: final_loss=" in capsys.readouterr().out

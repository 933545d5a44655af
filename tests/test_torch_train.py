"""The port's train path against the JAX package, on the CPU.

Reduced chatglm3-6b (4 layers, d 128, 4 heads, kv 2, dh 32, vocab 512,
RMSNorm, half rotary, QKV bias) and reduced stablelm-3b (LayerNorm, MHA,
quarter rotary): weights from JAX `init_model(cfg, PRNGKey(0))`, carried
across with `repro_torch.convert.from_jax_params`, batches from a numpy seed
with padded (masked) tails as `pack_batch` makes them.  On the CPU every
kernel wrapper, and so every autograd op's backward, runs its plain
version.  Gradients come back to the JAX layout with `to_jax_params`.

Tolerances: params cast to fp32 on both sides at TOL_F32 = 1e-4 (loss,
metrics, every gradient; the largest difference seen is 4e-7); bf16 params
at TOL_BF16 = 3e-2 (tests/test_kernels.py's), each gradient leaf relative to
its largest magnitude, against JAX jitted with `xla_allow_excess_precision`
off (see tests/test_torch_serve.py).  AdamW updates at 1e-5 on fp32 state
(one fp32 rounding of the update in a different order) and one bf16 ulp on
bf16 moments (whose params then agree to lr / 20 after 10 steps: an fp32
rounding apart can round a moment one bf16 ulp apart).
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import lr_at as jax_lr_at
from repro.optim.adamw import _decay_mask as jax_decay_mask
from repro.runtime.steps import train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.launch.train import Trainer, TrainerConfig, main
from repro_torch.models import loss_fn
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, lr_at
from repro_torch.optim.adamw import _decay_mask
from repro_torch.runtime.steps import make_train_state, train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 3e-2
STRICT_BF16 = {"xla_allow_excess_precision": False}
B, S = 2, 48
ARCHS = ["chatglm3-6b", "stablelm-3b"]

jax_value_and_grad_strict = jax.jit(
    jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(2,),
    compiler_options=STRICT_BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"arch": arch, "jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32}}


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


def _assert_trees_close(got, want, rel=None, floor=1.0, **tol):
    """Every leaf of `got` (numpy, JAX layout) against `want`; with `rel`,
    within rel x max(floor, the leaf's largest |value|)."""
    jax.tree_util.tree_map_with_path(lambda *a: None, want)   # same structure
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        if rel is not None:
            tol = dict(rtol=0, atol=rel * max(floor, float(np.abs(w).max())))
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def test_loss_and_every_grad_match_jax_f32(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = _batch(1, cfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        model["jax"]["f32"], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, tg = _grads(_torch_params(model, "f32"), batch, cfg)
    for key in ("loss", "ce", "aux", "ppl"):
        np.testing.assert_allclose(_np(metrics[key]), _np(jm[key]), **TOL_F32)
    np.testing.assert_allclose(_np(loss), _np(jl), **TOL_F32)
    _assert_trees_close(tg, jg, **TOL_F32)


def test_loss_and_every_grad_match_jax_bf16(model):
    jcfg, cfg = model["jcfg"], model["cfg"]
    batch = _batch(2, cfg.vocab_size)
    (jl, jm), jg = jax_value_and_grad_strict(
        model["jax"]["bf16"], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, tg = _grads(_torch_params(model, "bf16"), batch, cfg)
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(_np(metrics["ppl"]), _np(jm["ppl"]), rtol=TOL_BF16)
    for leaf in tree_leaves(tg):
        assert leaf.dtype.name == "bfloat16"
    _assert_trees_close(tg, jg, rel=TOL_BF16)


def test_remat_changes_nothing(model):
    from dataclasses import replace
    cfg = model["cfg"]
    batch = _batch(3, cfg.vocab_size)
    out = {}
    for remat in ("layer", "none"):
        loss, _, g = _grads(_torch_params(model, "f32"), batch, replace(cfg, remat=remat))
        out[remat] = (loss, g)
    assert float(out["layer"][0].detach()) == float(out["none"][0].detach())
    _assert_trees_close(out["layer"][1], out["none"][1], rtol=0, atol=0)


def test_loss_mask_defaults_to_ones(model):
    cfg = model["cfg"]
    batch = _batch(4, cfg.vocab_size)
    batch["loss_mask"] = np.ones_like(batch["loss_mask"])
    tb = _tb(batch)
    params = _torch_params(model, "f32")
    with torch.no_grad():
        a, _ = loss_fn(params, tb, cfg)
        b, _ = loss_fn(params, {k: v for k, v in tb.items() if k != "loss_mask"}, cfg)
    assert float(a) == float(b)


# ---------------------------------------------------------------------------
# AdamW (the three optimizer tests of tests/test_runtime.py, ported)
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params, cfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(lr_at(cfg, torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
    assert float(lr_at(cfg, torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0, rel=0.1)
    assert float(lr_at(cfg, torch.tensor(100, dtype=torch.int32))) == pytest.approx(0.1, rel=0.01)


def test_adamw_bf16_moments():
    cfg = AdamWConfig(moment_dtype=torch.bfloat16, warmup_steps=1)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    opt = init_opt_state(params, cfg)
    assert opt["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    p2, opt2, m = adamw_update(g, opt, params, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert float(m["grad_norm"]) == pytest.approx(4.0, rel=1e-2)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adamw_blocks_change_no_bit(monkeypatch, moments):
    """AdamW updates a leaf a block of rows at a time (at most BLOCK
    elements, one row at least): blocks of one row, of 3 rows (a ragged last
    block of [7, 3, 5]) and of 3 elements of a 1-D leaf, and a 0-d leaf,
    give the bits of each leaf updated whole, params and both moments, over
    three steps."""
    from repro_torch.optim import adamw
    shapes = {"w": (7, 3, 5), "b": (9,), "s": ()}
    cfg = AdamWConfig(moment_dtype=moments, warmup_steps=1)
    out = {}
    for block in (1 << 26, 15, 45, 3):
        monkeypatch.setattr(adamw, "BLOCK", block)
        rng = np.random.default_rng(5)         # the same draws for every block size
        params = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
            torch.bfloat16) for k, sh in shapes.items()}
        opt = init_opt_state(params, cfg)
        for step in range(3):
            g = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
                torch.bfloat16) for k, sh in shapes.items()}
            params, opt, _ = adamw_update(g, opt, params, cfg)
        out[block] = [params[k] for k in shapes] + [opt[mv][k] for mv in "mv" for k in shapes]
    for block in (15, 45, 3):
        assert all(torch.equal(a, b) for a, b in zip(out[block], out[1 << 26]))


@pytest.mark.parametrize("t", [0, 1, 50, 99, 100, 101, 5000, 20000])
def test_lr_at_matches_jax(t):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10000)
    want = jax.jit(lambda s: jax_lr_at(JaxAdamWConfig(**kw), s))(jnp.int32(t))
    np.testing.assert_allclose(float(lr_at(AdamWConfig(**kw), torch.tensor(t))),
                               float(want), rtol=1e-6)


def test_decay_mask_matches_jax_layout():
    """JAX decays by ndim on its stacked [L, ...] layout: the blocks' norm
    scales and QKV biases are decayed, only final_norm.scale is not."""
    jcfg = jax_get_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    want = jax_decay_mask(jp)
    got = _decay_mask(from_jax_params(_jnp(jp), cfg))
    for i in range(cfg.n_layers):
        assert tree_map(lambda m: bool(m), got["blocks"][i]) == \
            jax.tree_util.tree_map(bool, want["blocks"])
    assert got["blocks"][0]["attn_norm"]["scale"] and got["blocks"][0]["attn"]["bq"]
    assert got["blocks"][0]["ffn_norm"]["scale"]
    assert not got["final_norm"]["scale"] and not want["final_norm"]["scale"]
    assert got["embed"] == jax.tree_util.tree_map(bool, want["embed"])


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_ten_steps_match_jax(moments):
    """10 updates of the reduced chatglm3-6b params on identical grads (one
    numpy draw per step), decay on JAX's layout included."""
    jcfg = jax_get_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
    jcfg_opt = JaxAdamWConfig(**kw, moment_dtype={"f32": jnp.float32,
                                                  "bf16": jnp.bfloat16}[moments])
    tcfg_opt = AdamWConfig(**kw, moment_dtype={"f32": torch.float32,
                                               "bf16": torch.bfloat16}[moments])
    tp = from_jax_params(_jnp(jp), cfg)
    jopt, topt = jax_init_opt_state(jp, jcfg_opt), init_opt_state(tp, tcfg_opt)
    rng = np.random.default_rng(5)
    jupd = jax.jit(jax_adamw_update, static_argnums=(3,))
    for _ in range(10):
        gj = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3, _jnp(jp))
        jp, jopt, jm = jupd(gj, jopt, jp, jcfg_opt)
        tp, topt, tm = adamw_update(from_jax_params(gj, cfg), topt, tp, tcfg_opt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 10
    # with bf16 moments, an fp32 rounding apart can round a moment one bf16
    # ulp (2^-8) apart; over 10 steps the params then stay within lr / 20
    tol = 1e-5 if moments == "f32" else kw["lr"] / 20
    _assert_trees_close(to_jax_params(tp, cfg), jp, rtol=tol, atol=tol)
    # fp32 moments to 1e-5; bf16 moments, rounded anew each step, within
    # 2^-7 (two bf16 ulps) of each leaf's largest |value|
    for name in ("m", "v"):
        got_m, want_m = to_jax_params(topt[name], cfg), jopt[name]
        if moments == "f32":
            _assert_trees_close(got_m, want_m, rtol=1e-5, atol=1e-6)
        else:
            _assert_trees_close(got_m, want_m, rel=2 ** -7, floor=0.0)


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax():
    jcfg = jax_get_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
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
        _assert_trees_close(to_jax_params(tstate["params"], cfg), jstate["params"],
                            **TOL_F32)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases_on_cpu():
    """Port of tests/test_runtime.py::test_trainer_loss_decreases, without
    its checkpoint: a learnable corpus of repeated short patterns."""
    tc = TrainerConfig(arch="stablelm-3b", steps=30, global_batch=4, seq_len=32,
                       lr=1e-3, log_every=30, device="cpu")
    rng = np.random.default_rng(0)
    corpus = [np.tile(rng.integers(1, 64, size=8), 5).astype(np.uint32)
              for _ in range(64)]
    tr = Trainer(tc, corpus=corpus)
    out = tr.run()
    assert out["steps"] == 30 and len(out["losses"]) == 30
    assert out["final_loss"] < out["losses"][0], out["losses"]
    assert out["step_s"] > 0 and out["tokens_per_s"] > 0


def test_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    assert TrainerConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])


def test_trainer_default_corpus_matches_jax_batches():
    """Without batches or a corpus, the port synthesises the JAX Trainer's
    corpus and builds its batches as DataPipeline does."""
    from repro.data.tokens import pack_batch as jax_pack_batch
    tc = TrainerConfig(global_batch=4, seq_len=16, device="cpu")
    tr = Trainer(tc)
    rng = np.random.default_rng(0)
    corpus = [rng.integers(1, tr.cfg.vocab_size, size=17).astype(np.uint32)
              for _ in range(128)]
    first = next(tr.batches)
    idx = np.random.default_rng(0).permutation(128)[:4]
    toks, mask = jax_pack_batch([corpus[i] for i in idx], 17)
    np.testing.assert_array_equal(first["tokens"], toks[:, :-1])
    np.testing.assert_array_equal(first["labels"], toks[:, 1:])
    np.testing.assert_array_equal(first["loss_mask"], mask[:, 1:])


def test_jax_pipeline_over_buffetfs_feeds_the_port_trainer(tmp_path):
    """The JAX DataPipeline reads a corpus from a 2-server BuffetFS cluster
    and feeds the port's Trainer; its first-step loss equals the JAX
    Trainer's on the same batch and weights."""
    from repro.core import BAgent, BLib, BuffetCluster
    from repro.data import BuffetDataset, DataPipeline, ShardedSampler
    from repro.launch.train import Trainer as JaxTrainer
    from repro.launch.train import TrainerConfig as JaxTrainerConfig

    rng = np.random.default_rng(0)
    corpus = [rng.integers(1, 512, size=int(rng.integers(20, 34))).astype(np.uint32)
              for _ in range(32)]
    jtc = JaxTrainerConfig(arch="chatglm3-6b", steps=1, global_batch=4, seq_len=32,
                           log_every=1, ckpt_every=100, n_servers=2,
                           data_dir=str(tmp_path / "jax"), resume=False)
    jtr = JaxTrainer(jtc, corpus=corpus)
    jax_loss = jtr.run()["final_loss"]
    jtr.shutdown()

    cluster = BuffetCluster(root_dir=str(tmp_path / "port"), n_servers=2)
    agent = BAgent(cluster)
    try:
        dataset = BuffetDataset.build(BLib(agent), corpus, name="train")
        sampler = ShardedSampler(n_samples=len(dataset), global_batch=4,
                                 dp_rank=0, dp_size=1)
        pipeline = DataPipeline(dataset, sampler, seq_len=32)
        tc = TrainerConfig(arch="chatglm3-6b", steps=1, global_batch=4, seq_len=32,
                           log_every=1, device="cpu")
        tr = Trainer(tc, batches=pipeline)
        jp, _ = jax_init_model(jax_get_config("chatglm3-6b").reduced(),
                               jax.random.PRNGKey(0))
        tr.init_state(params=from_jax_params(_jnp(jp), tr.cfg))
        out = tr.run()
        pipeline.stop()
    finally:
        agent.shutdown()
        cluster.shutdown()
    assert out["losses"][0] == pytest.approx(jax_loss, rel=TOL_BF16, abs=TOL_BF16)


def test_train_main_runs_on_cpu(capsys):
    main(["--device", "cpu", "--arch", "chatglm3-6b", "--steps", "2", "--batch", "2",
          "--seq", "16", "--moment-dtype", "bfloat16"])
    assert "[trainer] done: final_loss=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_to_jax_params_round_trip_is_bitwise(model, dt):
    jp = _jnp(model["jax"][dt])
    back = to_jax_params(from_jax_params(jp, model["cfg"]), model["cfg"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(path)


def test_fixed_batch_repeated_is_learnable_by_the_trainer():
    """chip_smoke.py's train phase on the CPU, at the reduced size: one fixed
    batch repeated, bf16 moments; the loss falls."""
    cfg = get_config("chatglm3-6b").reduced()
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 32), np.float32)}
    tc = TrainerConfig(arch="chatglm3-6b", steps=4, global_batch=2, seq_len=32,
                       device="cpu", moment_dtype=torch.bfloat16)
    out = Trainer(tc, batches=itertools.repeat(fixed)).run()
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]

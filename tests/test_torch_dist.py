"""The port's distributed runtime on 4 gloo ranks, on the CPU, against the
plain (unsharded) port and the JAX package.

One spawn of 4 ranks (`_torch_dist_ranks.py`, which imports no JAX) runs
every check of every mesh; this file writes its inputs (JAX's reduced
weights carried across with `from_jax_params`, a batch from a numpy seed
with padded tails, a checkpoint), reads back what each rank saw, and holds
it to the plain port and to JAX, which run here.

Tolerances.  Sharded and plain differ in where sums are split and rounded:
* fp32 params: the loss within 1e-5 relative, every gradient leaf within
  relative L2 1e-4 (the largest seen is 3e-6), and against JAX at
  test_torch_train's TOL_F32;
* bf16 params, one `train_step`: the loss within 2e-2 relative of the
  plain port's and of JAX's, the params after it within relative L2 3e-2
  (chip_smoke's TOL_GRAD) taken together, the worst leaves printed.  The
  gradients are held leaf by leaf in fp32 alone: a DTensor product whose
  contraction is split is summed as bf16 partials, and the plain bf16 run
  is itself 2-4 % (relative L2) from the fp32 gradients on the attention
  weights and biases, so two bf16 runs differ by up to ~5.6 % on a leaf
  (chatglm3-6b's kv bias on (1, 4));
* AdamW on DTensors is held on the same (plain) gradients, every param and
  moment leaf within relative L2 1e-6: fed its own gradients, Adam's first
  step turns every gradient element into +-lr whatever its size, and the
  elements of chatglm3-6b's kv bias on the unrotated half, whose exact
  gradient is 0 (a key bias there shifts every score of a query alike),
  take the sign of rounding noise (7.6 % relative L2 apart even in fp32);
* the sharded serve path: each step's logits against the plain port's and
  JAX's (jitted with `xla_allow_excess_precision` off, as
  tests/test_torch_serve.py's), with fp32 weights elementwise at
  rtol = atol = 1e-2, that file's fp32 bound (the bf16 cache is where all
  sides round), and with bf16 weights at rtol = atol = 3e-2, that file's
  bf16 bound.  A sum that a mesh splits (the merge of a sequence-split
  cache's partial attention outputs, a row-parallel product) is summed in
  fp32 and rounded once, where the unsharded one rounds: the sharded and
  plain ports' bf16 logits then sit ~1e-4 apart.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from _torch_dist_ranks import (COMPRESS_SHAPES, SERVE_B, SERVE_CASES, SERVE_PROMPT, SERVE_STEPS,
                               SERVE_T, TRAIN_CASES, WORLD, join, start)
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.runtime.compression import _dequantize as jax_dequantize
from repro.runtime.compression import _quantize as jax_quantize
from repro.runtime.pipeline_par import pipeline_forward as jax_pipeline_forward
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.context import activation_specs, constrain
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.data import DirLib
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.compression import _dequantize, _quantize
from repro_torch.runtime.steps import make_train_state, train_step
from repro_torch.tree import tree_unflatten

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16_LOSS = 2e-2
TOL_GRAD = 3e-2
TOL_SERVE_BF16 = 3e-2   # tests/test_torch_serve.py's bf16 bound, elementwise
STRICT_BF16 = {"xla_allow_excess_precision": False}
B, S = 2, 48
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
ARCHS = sorted({a for a, _ in TRAIN_CASES})
CASES = [(a, s, dt) for a, s in TRAIN_CASES for dt in ("f32", "bf16")]


def _batch(seed, vocab):
    """tokens/labels shifted by one, and a loss mask with padded tails (as
    tests/test_torch_train.py's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    for i in range(B):
        n = int(rng.integers(S // 2, S + 1))
        toks[i, n + 1:] = 0
        mask[i, n:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _rel_all(got, want) -> float:
    """Relative L2 error of all leaves taken together."""
    got, want = [a.detach().float() for a in got], [b.detach().float() for b in want]
    return float(torch.cat([(a - b).flatten() for a, b in zip(got, want)]).norm()
                 / torch.cat([b.flatten() for b in want]).norm())


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the inputs, runs the 4 ranks once, returns (inputs, the
    record of every rank)."""
    tmp = tmp_path_factory.mktemp("dist")
    jax_params = {}
    params = {}
    for arch in ARCHS:
        jp, _ = jax_init_model(jax_get_config(arch).reduced(), jax.random.PRNGKey(0))
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        jax_params[arch] = {"bf16": jp, "f32": jp32}
        cfg = get_config(arch).reduced()
        params[arch] = {dt: from_jax_params(jax.tree_util.tree_map(np.asarray, p), cfg)
                        for dt, p in jax_params[arch].items()}
    rng = np.random.default_rng(3)
    pipeline = {"ws": torch.as_tensor(rng.standard_normal((WORLD, 16, 16)).astype(np.float32)
                                      * 0.1),
                "x": torch.as_tensor(rng.standard_normal((8, 16)).astype(np.float32))}
    # a checkpoint after one plain step (moments not zero), saved at train
    # step 3 with a sampler that ran ahead to step 5, as JAX's does
    cfg = get_config("chatglm3-6b").reduced()
    opt_cfg = AdamWConfig(**OPT)
    state = make_train_state(cfg, opt_cfg, torch.Generator().manual_seed(2), "cpu")
    state, _ = train_step(state, {k: torch.as_tensor(v).long() if k != "loss_mask"
                                  else torch.as_tensor(v)
                                  for k, v in _batch(4, cfg.vocab_size).items()}, cfg, opt_cfg)
    CheckpointManager(DirLib(str(tmp / "ckpt")), "elastic", parts=3).save(
        3, state, extra={"train_step": 3, "sampler": {"step": 5, "seed": 7}})
    batch = _batch(1, cfg.vocab_size)
    serve_tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)
    inputs = {"params": params, "opt": OPT,
              "serve": {"tokens": torch.as_tensor(serve_tokens).long()},
              "batch": {"tokens": torch.as_tensor(batch["tokens"]).long(),
                        "labels": torch.as_tensor(batch["labels"]).long(),
                        "loss_mask": torch.as_tensor(batch["loss_mask"])},
              "pipeline": pipeline,
              "elastic": {"arch": "chatglm3-6b", "run": "elastic", "global_batch": 8,
                          "n_samples": 64, "saved": state}}
    torch.save(inputs, tmp / "inputs.pt")
    ctx = start(str(tmp))
    try:        # JAX's side while the ranks run
        ref = _jax_ref(jax_params, batch)
        ref["serve"] = _jax_serve_ref(jax_params, serve_tokens)
    finally:
        join(ctx)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"inputs": inputs, "jax": ref, "ranks": ranks}


def _jax_ref(jax_params, batch) -> dict:
    """JAX's loss and gradients on the same weights and batch, per (arch, dtype)."""
    out = {}
    vg = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(2,))
    vg_bf16 = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(2,),
                      compiler_options=STRICT_BF16)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for arch in ARCHS:
        jcfg = jax_get_config(arch).reduced()
        for dt, fn in (("f32", vg), ("bf16", vg_bf16)):
            (loss, _), grads = fn(jax_params[arch][dt], batch, jcfg)
            out[(arch, dt)] = (float(loss), grads)
    return out


def _jax_serve_ref(jax_params, tokens) -> dict:
    """JAX's logits of the serve cases' prefill and teacher-forced decode
    steps, per (arch, weights' dtype)."""
    prefill = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
    decode = jax.jit(jax_decode_step, static_argnums=(2,), compiler_options=STRICT_BF16)
    out = {}
    for arch, dt in itertools.product(sorted({a for a, _ in SERVE_CASES}), ("f32", "bf16")):
        jcfg, p = jax_get_config(arch).reduced(), jax_params[arch][dt]
        cache = jax_init_cache(jcfg, SERVE_B, SERVE_T)
        lg, cache = prefill(p, {"tokens": jnp.asarray(tokens[:, :SERVE_PROMPT])}, jcfg, cache)
        logits = [np.asarray(lg, np.float32)]
        for i in range(SERVE_STEPS):
            pos = SERVE_PROMPT + i
            lg, cache = decode(p, {"tokens": jnp.asarray(tokens[:, pos:pos + 1])}, jcfg, cache,
                               jnp.int32(pos))
            logits.append(np.asarray(lg, np.float32))
        out[(arch, dt)] = logits
    return out


@pytest.fixture(scope="module")
def jax_ref(world):
    return world["jax"]


def _case(world, case, rank=0):
    return world["ranks"][rank]["train"][case]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "f32"], ids=str)
def test_sharded_loss_and_every_grad_f32(world, jax_ref, case):
    arch, _, dt = case
    rec = _case(world, case)
    cfg = get_config(arch).reduced()
    names = _names(world["inputs"]["params"][arch][dt])
    assert abs(rec["loss"] - rec["plain_loss"]) <= 1e-5 * abs(rec["plain_loss"])
    errs = {n: _rel(g, p) for n, g, p in zip(names, rec["grads"], rec["plain_grads"])}
    worst = max(errs, key=errs.get)
    print(f"{case}: worst leaf {worst} relative L2 {errs[worst]:.3g}")
    assert errs[worst] <= 1e-4, errs
    jloss, jgrads = jax_ref[(arch, dt)]
    np.testing.assert_allclose(rec["loss"], jloss, **TOL_F32)
    got = to_jax_params(tree_unflatten(world["inputs"]["params"][arch][dt], rec["grads"]), cfg)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **TOL_F32)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_every_leaf_at_its_specs_placements_and_local_shape(world, case, rank):
    rec = _case(world, case, rank)
    assert rec["placement_faults"] == [] and rec["batch_faults"] == []
    assert rec["distribute_params_faults"] == []
    assert rec["grad_placements_ok"] if case[2] == "f32" else rec["step"]["metrics_plain"]


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "f32"], ids=str)
def test_adamw_on_shards_matches_the_plain_update(world, case):
    for rank in range(WORLD):
        rec = _case(world, case, rank)["adamw"]
        got_norm, want_norm = rec["grad_norm"]
        assert abs(got_norm - want_norm) <= 1e-6 * want_norm
        assert max(_rel(a, b) for a, b in rec["leaves"]) <= 1e-6
        assert rec["placement_faults"] == []


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "bf16"], ids=str)
def test_sharded_train_step_bf16(world, jax_ref, case):
    """One `train_step` on the sharded bf16 state: its loss beside the plain
    step's and JAX's, the state out at the placements it went in with, the
    metrics plain tensors, the params within 3e-2 taken together (the worst
    leaves printed)."""
    rec = _case(world, case)["step"]
    jloss, _ = jax_ref[(case[0], "bf16")]
    for want in (rec["plain_loss"], jloss):
        assert abs(rec["loss"] - want) <= TOL_BF16_LOSS * abs(want)
    assert rec["placement_faults"] == [] and rec["metrics_plain"]
    names = _names(world["inputs"]["params"][case[0]]["bf16"])
    errs = {n: _rel(a, b) for n, a, b in zip(names, rec["params"], rec["plain_params"])}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    print(f"{case}: worst leaves {[(n, round(errs[n], 4)) for n in worst]}")
    assert _rel_all(rec["params"], rec["plain_params"]) <= TOL_GRAD


def test_activation_specs_of_the_meshes(world):
    """(2, 2): heads and kv over model, the sequence over model in bsd;
    chatglm3-6b on (1, 4): its 2 kv heads do not divide 4, so no seq <->
    head transition."""
    two = _case(world, ("chatglm3-6b", (2, 2), "f32"))["act_specs"]
    assert two["bsd"] == ("data", "model", None) and two["heads"] == ("data", None, "model",
                                                                      None)
    four = _case(world, ("chatglm3-6b", (1, 4), "f32"))["act_specs"]
    assert four["bsd"] == ("data", "model", None) and four["heads"] is None
    assert four["kv"] is None


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", COMPRESS_SHAPES + ((256,), (2, 256)), ids=str)
def test_quantize_and_dequantize_are_jaxs_bitwise(shape, dtype):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 3.0
    x.flat[0] = 0.0
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    q, s = _quantize(tx)
    jq, js = jax_quantize(jnp.asarray(x).astype(getattr(jnp, dtype)))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    got = _dequantize(q, s, shape, torch.float32).numpy()
    want = np.asarray(jax_dequantize(jq, js, shape, jnp.float32))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_compressed_psum_tree_is_the_int8_algebra(world):
    """Every rank's result is, bitwise, the algebra on the two ranks of its
    pod group: int32 sum of both ranks' int8 blocks, max of their scales,
    dequantized in the leaf's dtype, halved; and within the quantization
    bound of the true mean: per element (|q_a|(s - s_a) + s_a / 2 + |q_b|(s
    - s_b) + s_b / 2) / 2 with s the max scale (the max scale rescales each
    rank's integers), plus the output dtype's rounding."""
    recs = [r["compress"] for r in world["ranks"]]
    for r in recs:
        assert r["absent_is_identity"] and r["size1_is_identity"]
        group = [o for o in recs if o["coord"][1] == r["coord"][1]]
        assert len(group) == 2
        for name, out in r["out"].items():
            gs = [o["grads"][name] for o in group]
            qs = [_quantize(g) for g in gs]
            qsum = sum(q.to(torch.int32) for q, _ in qs)
            smax = torch.maximum(qs[0][1], qs[1][1])
            want = _dequantize(qsum, smax, gs[0].shape, gs[0].dtype) / 2
            assert out.dtype == gs[0].dtype and torch.equal(out, want), name
            n = gs[0].numel()
            bound = sum(q.abs().float() * (smax - s) + s / 2 for q, s in qs
                        ).reshape(-1)[:n].reshape(gs[0].shape) / 2
            mean = (gs[0].float() + gs[1].float()) / 2
            ulp = 2.0 ** -8 if out.dtype == torch.bfloat16 else 2.0 ** -22
            assert bool(((out.float() - mean).abs() <= bound + ulp * mean.abs() + 1e-12).all())


# ---------------------------------------------------------------------------
# pipeline, elastic restore, constrain, refusals
# ---------------------------------------------------------------------------

def test_pipeline_forward_matches_sequential_and_jax(world):
    ws, x = world["inputs"]["pipeline"]["ws"], world["inputs"]["pipeline"]["x"]
    ref = x
    for i in range(WORLD):
        ref = torch.tanh(ref @ ws[i])
    mesh = jax.make_mesh((WORLD,), ("pod",))
    with mesh:
        jout = jax_pipeline_forward(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws.numpy()),
                                    jnp.asarray(x.numpy()), mesh=mesh, axis="pod",
                                    n_microbatches=4)
    for r in world["ranks"]:
        for out in (r["pipeline"]["out"], r["pipeline"]["out_dtensor"]):
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


def test_elastic_restore_onto_2x2_is_bitwise_and_the_sampler_at_the_train_step(world):
    for r in world["ranks"]:
        rec = r["elastic"]
        assert rec["mesh"] == {"data": 2, "model": 2}
        assert rec["remesh"] == {"data": 1, "model": 4}
        assert rec["locals_bitwise"] and rec["shards"] > 0 and rec["opt_step_plain"]
        # the saved train step, not the sampler's own run-ahead step 5
        assert rec["step"] == 3 and rec["sampler"] == {"step": 3, "seed": 7}


def test_constrain_without_specs_returns_its_argument_and_issues_no_collective(world):
    for r in world["ranks"]:
        rec = r["constrain"]
        assert rec["no_specs_same"] and rec["plain_same"] and rec["none_spec_same"]
        assert rec["no_op_collectives"] == 0
        assert rec["moved_collectives"] > 0 and rec["moved_equal"]
        assert rec["moved_placements"] == [str(Shard(0)), str(Shard(1))]
    x = torch.randn(2, 3)
    assert constrain(x, "bsd") is x
    with activation_specs({"bsd": ("data", None)}):
        assert constrain(x, "bsd") is x


def test_shard_train_state_refuses_the_other_families_on_a_mesh(world):
    for arch, msg in world["ranks"][0]["raises"].items():
        family = get_config(arch).family
        assert msg is not None and family in msg and arch in msg


# ---------------------------------------------------------------------------
# the sharded serve path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_sharded_prefill_and_decode_match_the_plain_port_and_jax(world, jax_ref, case, dt):
    """Every rank's logits of the prefill and the 4 decode steps against the
    plain port's and JAX's, elementwise (fp32 at 1e-2, bf16 at 3e-2: the
    module's docstring); the cache stays a DTensor at
    `cache_specs`' placements: chatglm3-6b's 2 kv heads on (1, 4) leave its
    sequence split over "model", on (2, 2) and stablelm-3b's 32 heads split
    the heads."""
    want_pl = [str(Shard(1)), str(Shard(2 if case == ("chatglm3-6b", (1, 4)) else 3))]
    worst = 0.0
    for r in world["ranks"]:
        rec = r["serve"][(*case, dt)]
        assert rec["cache_is_dtensor"] and rec["cache_placements"] == want_pl
        assert len(rec["logits"]) == 1 + SERVE_STEPS
        for got, plain, want in zip(rec["logits"], rec["plain_logits"],
                                    jax_ref["serve"][(case[0], dt)]):
            got = got.float().numpy()
            for ref in (plain.float().numpy(), want):
                tol = 1e-2 if dt == "f32" else TOL_SERVE_BF16
                worst = max(worst, float((np.abs(got - ref) - tol * np.abs(ref)).max()))
                np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    print(f"{case} {dt}: worst |diff| - rtol |want| {worst:.4g}")


@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_decode_never_gathers_the_cache(world, case):
    """No collective of a decode step outputs a tensor with the cache's
    SERVE_T rows; on the sequence-split cache each step gathers the
    partials' [4, B, H] lse and [4, B, H, D] outputs of every layer, the
    merge by log-sum-exp; a head-split cache needs no merge."""
    cfg = get_config(case[0]).reduced()
    n_merge = 2 * cfg.n_layers * SERVE_STEPS if case == ("chatglm3-6b", (1, 4)) else 0
    for r in world["ranks"]:
        shapes = r["serve"][(*case, "bf16")]["decode_collectives"]
        assert shapes and not [s for s in shapes if SERVE_T in s[1]], shapes
        merges = [s for _, s in shapes if s[0] == WORLD and s[1:3] == (SERVE_B, cfg.n_heads)]
        assert len(merges) == n_merge, shapes

"""The ssm and moe families under a mesh on 4 gloo ranks, on the CPU, against
the plain (unsharded) port and the JAX package.

One spawn of 4 ranks (`_torch_dist_families_ranks.py`, which imports no JAX)
runs every case; this file writes the inputs (JAX's reduced weights at fp32
carried across with `from_jax_params`, a batch from a numpy seed with a
padded tail, the serve tokens), computes JAX's references while the ranks
run, and holds what each rank saw to the plain port and to JAX.

The cases: reduced mamba2-130m on (2, 2) and (1, 4), whose 8 SSD heads
divide "model" (each rank its heads); the same at d_model 96 on (1, 4): 6
heads, and in_proj's 454 columns whole over "model", the branch full-width
mamba2-130m's 24 heads on 16 take (each rank its piece of the sequence,
the scan in two passes); reduced deepseek-v2-lite-16b on (2, 2) and (1, 4)
(the experts over "model": an all-to-all of the kept routes in train and
prefill, each rank its own experts' partial sum in decode); reduced
deepseek-v3-671b on (2, 2), train only (q-LoRA, the sigmoid router with its
router_bias, the MTP loss).  MoE layers run at the default capacity factor
1.25, and the inputs drop routes: each rank keeps exactly the plain step's
routes at its tokens.

Tolerances, tests/test_torch_dist.py's at fp32 params: the loss within 1e-5
relative of the plain port's, every gradient leaf within relative L2 1e-4
of it; the loss and every gradient against JAX elementwise at TOL_F32; each
serve step's logits against the plain port's and JAX's elementwise at
rtol = atol = 1e-2 (tests/test_torch_serve.py's fp32 bound: the bf16 caches
are where every side rounds).
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_families_ranks import (B, S, SERVE_B, SERVE_CASES, SERVE_PROMPT, SERVE_STEPS,
                                        SERVE_T, TRAIN_CASES, WORLD, config, join, start)
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.tree import tree_unflatten

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_SERVE = 1e-2
MODELS = sorted({(a, o) for a, _, o in TRAIN_CASES})


def _batch(seed, vocab):
    """tokens/labels shifted by one, and a loss mask with a padded tail."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    n = int(rng.integers(S // 2, S))
    toks[1, n + 1:] = 0
    mask[1, n:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _jax_cfg(arch, overrides):
    return jax_get_config(arch).reduced(**dict(overrides))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the inputs, runs the 4 ranks once, returns (inputs, JAX's
    references, the record of every rank)."""
    tmp = tmp_path_factory.mktemp("dist_families")
    jax_params, params = {}, {}
    for arch, over in MODELS:
        jp, _ = jax_init_model(_jax_cfg(arch, over), jax.random.PRNGKey(0))
        jax_params[(arch, over)] = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        params[(arch, over)] = from_jax_params(
            jax.tree_util.tree_map(np.asarray, jax_params[(arch, over)]), config(arch, over))
    batch = _batch(1, 512)
    serve_tokens = np.random.default_rng(5).integers(
        1, 512, (SERVE_B, SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)
    inputs = {"params": params, "serve_tokens": torch.as_tensor(serve_tokens).long(),
              "batch": {"tokens": torch.as_tensor(batch["tokens"]).long(),
                        "labels": torch.as_tensor(batch["labels"]).long(),
                        "loss_mask": torch.as_tensor(batch["loss_mask"])}}
    torch.save(inputs, tmp / "inputs.pt")
    ctx = start(str(tmp))
    try:        # JAX's side while the ranks run
        ref = {"train": _jax_train(jax_params, batch),
               "serve": _jax_serve(jax_params, serve_tokens)}
    finally:
        join(ctx)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"inputs": inputs, "jax": ref, "ranks": ranks}


def _jax_train(jax_params, batch) -> dict:
    vg = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(2,))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for arch, over in MODELS:
        (loss, _), grads = vg(jax_params[(arch, over)], batch, _jax_cfg(arch, over))
        out[(arch, over)] = (float(loss), grads)
    return out


def _jax_serve(jax_params, tokens) -> dict:
    prefill = jax.jit(jax_prefill, static_argnums=(2,))
    decode = jax.jit(jax_decode_step, static_argnums=(2,))
    out = {}
    for arch, over in sorted({(a, o) for a, _, o in SERVE_CASES}):
        jcfg, p = _jax_cfg(arch, over), jax_params[(arch, over)]
        cache = jax_init_cache(jcfg, SERVE_B, SERVE_T)
        lg, cache = prefill(p, {"tokens": jnp.asarray(tokens[:, :SERVE_PROMPT])}, jcfg, cache)
        logits = [np.asarray(lg, np.float32)]
        for i in range(SERVE_STEPS):
            pos = SERVE_PROMPT + i
            lg, cache = decode(p, {"tokens": jnp.asarray(tokens[:, pos:pos + 1])}, jcfg, cache,
                               jnp.int32(pos))
            logits.append(np.asarray(lg, np.float32))
        out[(arch, over)] = logits
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TRAIN_CASES, ids=str)
def test_sharded_loss_and_every_grad_match_the_plain_port_and_jax(world, case):
    arch, _, over = case
    cfg = config(arch, over)
    params = world["inputs"]["params"][(arch, over)]
    names = _names(params)
    jloss, jgrads = world["jax"]["train"][(arch, over)]
    for r in world["ranks"]:
        rec = r["train"][case]
        assert rec["placement_faults"] == [] and rec["grad_placements_ok"]
        assert abs(rec["loss"] - rec["plain_loss"]) <= 1e-5 * abs(rec["plain_loss"])
        errs = {n: _rel(g, p) for n, g, p in zip(names, rec["grads"], rec["plain_grads"])}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-4, (worst, errs[worst])
    print(f"{case}: worst leaf {worst} relative L2 {errs[worst]:.3g}")
    rec = world["ranks"][0]["train"][case]
    np.testing.assert_allclose(rec["loss"], jloss, **TOL_F32)
    got = to_jax_params(tree_unflatten(params, rec["grads"]), cfg)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **TOL_F32)


@pytest.mark.parametrize("case", [c for c in TRAIN_CASES if c[0] != "mamba2-130m"], ids=str)
def test_global_capacity_drops_the_plain_steps_routes(world, case):
    """At capacity factor 1.25 the plain step drops routes, and every rank
    keeps exactly the plain step's routes at its tokens, call by call (the
    forward and the remat's recompute of each MoE layer), in train and in
    the serve steps."""
    for r in world["ranks"]:
        recs = [r["train"][case]["routes"]]
        if case in SERVE_CASES:
            recs.append(r["serve"][case]["routes"])
        for rec in recs:
            assert rec["calls"] > 0 and rec["plain_dropped"] > 0 and rec["kept_equal"], rec


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_sharded_prefill_and_decode_match_the_plain_port_and_jax(world, case):
    """Every rank's logits of the prefill and 4 decode steps against the
    plain port's and JAX's, elementwise at 1e-2; every param and cache leaf
    at its spec's placements."""
    arch, _, over = case
    worst = 0.0
    for r in world["ranks"]:
        rec = r["serve"][case]
        assert rec["cache_faults"] == [] and rec["param_faults"] == []
        assert len(rec["logits"]) == 1 + SERVE_STEPS
        for got, plain, want in zip(rec["logits"], rec["plain_logits"],
                                    world["jax"]["serve"][(arch, over)]):
            got = got.float().numpy()
            for ref in (plain.float().numpy(), want):
                worst = max(worst, float((np.abs(got - ref) - TOL_SERVE * np.abs(ref)).max()))
                np.testing.assert_allclose(got, ref, rtol=TOL_SERVE, atol=TOL_SERVE)
    print(f"{case}: worst |diff| - rtol |want| {worst:.4g}")


@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_decode_never_gathers_the_cache(world, case):
    """No collective of a decode step outputs a tensor of the cache's
    SERVE_T rows (MLA's latent or rotary keys, mamba2's conv or scan state
    at any width): the decode steps move activations, scores and partial
    sums only.  MLA's scores and weights span the cache's SERVE_T rows in
    their last dim (every row is read under the causal mask, as JAX's cache
    branch reads them, so a decode step's shapes do not depend on its
    position); a cache's rows come before its columns."""
    arch, _, over = case
    cfg = config(arch, over)
    if cfg.family == "ssm":      # the conv state's W - 1 rows and the scan state's heads
        d_inner = cfg.ssm.expand * cfg.d_model
        cache_dims = [(cfg.ssm.d_conv - 1, d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state),
                      (d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim)]
    else:
        cache_dims = [(SERVE_T,)]
    for r in world["ranks"]:
        shapes = r["serve"][case]["decode_collectives"]
        assert shapes
        for _, shp in shapes:
            rows = shp if cfg.family == "ssm" else shp[:-1]
            for dims in cache_dims:
                assert not any(rows[i:i + len(dims)] == dims for i in range(len(rows))), shapes

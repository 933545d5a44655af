"""The hybrid family under a mesh on 4 gloo ranks, on the CPU, against the
plain (unsharded) port and the JAX package.

One spawn of 4 ranks (`_torch_dist_hybrid_ranks.py`, which imports no JAX)
runs every case; this file writes the inputs (JAX's reduced
jamba-1.5-large-398b weights at fp32 carried across with `from_jax_params`,
a batch from a numpy seed with a padded tail, the serve tokens), computes
JAX's references while the ranks run, and holds what each rank saw to the
plain port and to JAX.

The cases: reduced jamba on (2, 2), where its 4 kv heads divide "model" (the
KV cache splits by heads), and on (1, 4) at 2 kv heads, which do not divide
4: each rank's one query head reads the kv head of its GQA group, the cache
splits by sequence and each decode step merges the ranks' partial attention
by their lse, as full-width jamba's 8 kv heads on 16.  Both put a period
block's Mamba layers (8 SSD heads over "model": each rank its heads), its
expert-parallel MoE layers (8 experts, top-2, capacity factor 1.25) and its
GQA layer side by side.  The (1, 4) serve case runs two period blocks
(n_layers 16), so the cache's block index is read and written.

Tolerances, tests/test_torch_dist.py's at fp32 params: the loss within 1e-5
relative of the plain port's, every gradient leaf within relative L2 1e-4
of it; the loss and every gradient against JAX elementwise at TOL_F32; each
serve step's logits against the plain port's and JAX's elementwise at
rtol = atol = 1e-2 (tests/test_torch_serve.py's fp32 bound: the bf16 caches
are where every side rounds).  The cache read back after the decode steps,
every leaf and each rank's own shard of it, within relative L2 TOL_CACHE of
the plain port's: its keys, values and conv states are bf16, whose ulp is
2^-8 relative, and each side rounds them from its own sums.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_families_ranks import join
from _torch_dist_hybrid_ranks import (SERVE_B, SERVE_CASES, SERVE_PROMPT, SERVE_STEPS, SERVE_T,
                                      TRAIN_CASES, WORLD, config, start)
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.runtime.sharding import cache_specs
from repro_torch.tree import tree_unflatten
from test_torch_dist_families import _batch, _names, _rel

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_SERVE = 1e-2
TOL_CACHE = 1e-2
ARCH = "jamba-1.5-large-398b"
MODELS = sorted({o for _, o in TRAIN_CASES + SERVE_CASES})


def _jax_cfg(overrides):
    return jax_get_config(ARCH).reduced(**dict(overrides))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the inputs, runs the 4 ranks once, returns (inputs, JAX's
    references, the record of every rank)."""
    tmp = tmp_path_factory.mktemp("dist_hybrid")
    jax_params, params = {}, {}
    for over in MODELS:
        jp, _ = jax_init_model(_jax_cfg(over), jax.random.PRNGKey(0))
        jax_params[over] = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        params[over] = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params[over]),
                                       config(over))
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
    for _, over in TRAIN_CASES:
        (loss, _), grads = vg(jax_params[over], batch, _jax_cfg(over))
        out[over] = (float(loss), grads)
    return out


def _jax_serve(jax_params, tokens) -> dict:
    prefill = jax.jit(jax_prefill, static_argnums=(2,))
    decode = jax.jit(jax_decode_step, static_argnums=(2,))
    out = {}
    for _, over in SERVE_CASES:
        jcfg, p = _jax_cfg(over), jax_params[over]
        cache = jax_init_cache(jcfg, SERVE_B, SERVE_T)
        lg, cache = prefill(p, {"tokens": jnp.asarray(tokens[:, :SERVE_PROMPT])}, jcfg, cache)
        logits = [np.asarray(lg, np.float32)]
        for i in range(SERVE_STEPS):
            pos = SERVE_PROMPT + i
            lg, cache = decode(p, {"tokens": jnp.asarray(tokens[:, pos:pos + 1])}, jcfg, cache,
                               jnp.int32(pos))
            logits.append(np.asarray(lg, np.float32))
        out[over] = logits
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TRAIN_CASES, ids=str)
def test_sharded_loss_and_every_grad_match_the_plain_port_and_jax(world, case):
    """Every rank's loss (its MoE layers' aux losses summed in it, as the
    unsharded block sums them) and every gradient against the plain port's,
    and rank 0's against JAX's `value_and_grad`; every param and moment
    leaf at its spec's placements, every gradient at its param's."""
    _, over = case
    cfg = config(over)
    params = world["inputs"]["params"][over]
    names = _names(params)
    jloss, jgrads = world["jax"]["train"][over]
    for r in world["ranks"]:
        rec = r["train"][case]
        assert rec["placement_faults"] == [] and rec["grad_placements_ok"]
        assert abs(rec["loss"] - rec["plain_loss"]) <= 1e-5 * abs(rec["plain_loss"])
        assert abs(rec["aux"] - rec["plain_aux"]) <= 1e-5 * abs(rec["plain_aux"])
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


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_sharded_prefill_and_decode_match_the_plain_port_and_jax(world, case):
    """Every rank's logits of the prefill and 4 decode steps against the
    plain port's and JAX's, elementwise at 1e-2; every param leaf at its
    spec's placements."""
    _, over = case
    worst = 0.0
    for r in world["ranks"]:
        rec = r["serve"][case]
        assert rec["param_faults"] == []
        assert len(rec["logits"]) == 1 + SERVE_STEPS
        for got, plain, want in zip(rec["logits"], rec["plain_logits"],
                                    world["jax"]["serve"][over]):
            got = got.float().numpy()
            for ref in (plain.float().numpy(), want):
                worst = max(worst, float((np.abs(got - ref) - TOL_SERVE * np.abs(ref)).max()))
                np.testing.assert_allclose(got, ref, rtol=TOL_SERVE, atol=TOL_SERVE)
    print(f"{case}: worst |diff| - rtol |want| {worst:.4g}")


@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_cache_read_back_holds_the_new_states_in_each_ranks_shard(world, case):
    """After the decode steps the cache's leaves are DTensors at
    `cache_specs`' placements ([NB, 7, ...] conv and scan states, [NB, ...]
    keys and values); every period block's every Mamba slot holds a conv
    and a scan state the decode steps changed, and the whole cache and each
    rank's own shard of it are the plain port's within TOL_CACHE."""
    shape, over = case
    cfg = config(over)
    nb = cfg.n_layers // cfg.hybrid.period
    specs = cache_specs(cfg, dict(zip(("data", "model"), shape)), SERVE_B, SERVE_T)
    if cfg.n_kv_heads % shape[1]:           # the keys and values split by sequence
        assert specs["kv"]["k"][2] == "model"
    else:
        assert specs["kv"]["k"][3] == "model"
    for r in world["ranks"]:
        rec = r["serve"][case]
        assert rec["cache_faults"] == []
        cache, plain, before = rec["cache"], rec["plain_cache"], rec["prefill_cache"]
        assert cache["conv"].shape[:2] == cache["ssm"].shape[:2] == (nb, cfg.hybrid.period - 1)
        for leaf in ("conv", "ssm"):
            for i in range(nb):
                for j in range(cfg.hybrid.period - 1):
                    assert not torch.equal(cache[leaf][i, j], before[leaf][i, j]), (leaf, i, j)
            assert _rel(cache[leaf], plain[leaf]) <= TOL_CACHE, leaf
        for leaf in ("k", "v"):
            assert _rel(cache["kv"][leaf], plain["kv"][leaf]) <= TOL_CACHE, leaf
        worst = max(rec["local_rel_l2"], key=rec["local_rel_l2"].get)
        assert rec["local_rel_l2"][worst] <= TOL_CACHE, (worst, rec["local_rel_l2"])


@pytest.mark.parametrize("case", SERVE_CASES, ids=str)
def test_decode_never_gathers_the_cache(world, case):
    """No collective of a decode step outputs a tensor of the cache's
    SERVE_T rows, nor a conv state's W - 1 rows of its channels or a scan
    state's heads: the decode steps move activations, scores, partial sums
    and the token's conv outputs only."""
    _, over = case
    cfg = config(over)
    d_inner = cfg.ssm.expand * cfg.d_model
    cache_dims = [(SERVE_T,),
                  (cfg.ssm.d_conv - 1, d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state),
                  (d_inner // cfg.ssm.head_dim, cfg.ssm.head_dim)]
    for r in world["ranks"]:
        shapes = r["serve"][case]["decode_collectives"]
        assert shapes
        for _, shp in shapes:
            for dims in cache_dims:
                assert not any(shp[i:i + len(dims)] == dims for i in range(len(shp))), shapes

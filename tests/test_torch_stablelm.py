"""Head dim 80 (stablelm-3b's full width: d 2560, 32 heads) in the port,
against the JAX package, on the CPU.

* The Pallas flash forward and backward and the Pallas decode kernel, run
  in interpret mode at D = 80 (S a multiple of the Pallas block), against
  the port's plain versions, at tests/test_kernels.py's tolerances (TOL for
  fp32, TOL_BF16 for bf16).
* The dq pass's work items (`dq_items`, the mirror of the kernel's
  numbering, which at rep 1 gives each of a block's two warpgroups one of
  two adjacent q tiles of a head): every (batch, head, q tile) once, the
  items with the most kv tiles first; and `flash_attention_bwd` on CPU
  tensors at D = 80 is the plain backward of the attention (every pass
  takes D = 80 natively on the card).
* Reduced stablelm-3b with `reduced(d_head=80)` on both sides (4 layers, d
  128, 4 heads of 80, LayerNorm, quarter rotary), weights from JAX
  `init_model(cfg, PRNGKey(0))` carried across with `from_jax_params`: the
  loss and every gradient against `jax.value_and_grad` (fp32 params at
  1e-4; bf16 params at 3e-2 of each leaf's largest magnitude, JAX jitted
  with `xla_allow_excess_precision` off), and a prefill plus 8 decode steps
  against JAX `prefill` / `decode_step` (bf16 at rtol = atol = 3e-2, fp32
  at 1e-2), as tests/test_torch_train.py and tests/test_torch_serve.py
  hold the other reduced models.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import math
from dataclasses import asdict

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention as jax_decode_kernel
from repro.kernels.flash_attention.kernel import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_tensor
from repro_torch.kernels import decode_attention, flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.decode_attention.kernel import (CLUSTERS, HEAD_DIMS as DECODE_DIMS,
                                                         cluster_size, head_chunks)
from repro_torch.kernels.flash_attention import (attention_bwd_dkv_ref, attention_bwd_dq_ref,
                                                 attention_bwd_ref, attention_with_lse_ref)
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, dq_items
from repro_torch.models import decode_step, init_cache, loss_fn, prefill
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "stablelm-3b"
TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
STRICT_BF16 = {"xla_allow_excess_precision": False}
B, S, MAX_LEN = 2, 16, 32


def _rand(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return TOL if dtype is np.float32 else TOL_BF16


# ---------------------------------------------------------------------------
# configs and the head dims the kernels take
# ---------------------------------------------------------------------------

def test_stablelm_config_is_jax_and_its_head_dim_is_taken():
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    assert asdict(tc) == asdict(jc)
    assert tc.head_dim == jc.head_dim == 80
    assert asdict(tc.reduced(d_head=80)) == asdict(jc.reduced(d_head=80))
    assert 80 in HEAD_DIMS and 80 in DECODE_DIMS and 48 not in HEAD_DIMS


@pytest.mark.parametrize("items,want", [(8, 8), (128, 1), (132, 1), (16, 4), (33, 2), (1, 8)])
def test_decode_cluster_size(items, want):
    """chatglm3-6b's 8 kv groups take clusters of 8; stablelm-3b's 128
    (sequence, head) pairs one block each: the grid stays within half the
    card's 132 SMs."""
    assert cluster_size(items) == want and want in CLUSTERS


@pytest.mark.parametrize("rep,chunks", [(1, 1), (16, 1), (17, 1), (32, 1), (33, 2), (128, 4)])
def test_decode_head_chunks(rep, chunks):
    assert head_chunks(rep) == chunks


# ---------------------------------------------------------------------------
# the Pallas kernels at D = 80 (interpret mode) against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,s", [(1, 2, 2, 64), (2, 4, 2, 96)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pallas_flash_at_d80_matches_plain(b, h, hkv, s, dt):
    """Forward (out, lse) and backward (dq, dk, dv) of the Pallas kernels at
    D = 80, blocks of 32, against the port's wrappers on CPU tensors."""
    rng = np.random.default_rng(30)
    q, k, v = (_rand(rng, (b, n, s, 80), DTYPES[dt]) for n in (h, hkv, hkv))
    do = _rand(rng, (b, h, s, 80), DTYPES[dt])
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jo, jl = jax_flash_fwd(jq, jk, jv, block_q=32, block_kv=32, interpret=True)
    out, lse = flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v))
    tol = _tol(DTYPES[dt])
    np.testing.assert_allclose(_np(out), _np(jo), **tol)
    np.testing.assert_allclose(_np(lse), _np(jl), rtol=1e-2, atol=1e-2)
    grads = jax_flash_bwd(jq, jk, jv, jo, jl, jnp.asarray(do), block_q=32, block_kv=32,
                          interpret=True)
    tg = flash_attention_bwd(*(to_tensor(np.asarray(a)) for a in (q, k, v, jo, jl, do)))
    for got, want in zip(tg, grads):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(_np(want)).max())))


@pytest.mark.parametrize("b,h,hkv,t,bkv", [(2, 4, 4, 64, 16), (3, 8, 2, 128, 32)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pallas_decode_at_d80_matches_plain(b, h, hkv, t, bkv, dt):
    rng = np.random.default_rng(31)
    q = _rand(rng, (b, h, 80), DTYPES[dt])
    k = _rand(rng, (b, t, hkv, 80), DTYPES[dt])
    v = _rand(rng, (b, t, hkv, 80), DTYPES[dt])
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)  # JAX gives NaN at 0
    out = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths))
    ref = jax_decode_kernel(*(jnp.asarray(a) for a in (q, k, v, lengths)), block_kv=bkv,
                            interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(DTYPES[dt]))


# ---------------------------------------------------------------------------
# the dq pass's work items, and the backward at D = 80 on the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, 2, 3, 16])
@pytest.mark.parametrize("b,s,q_offset,kv_len,causal", [
    (2, 256, 0, None, True),        # 4 q tiles
    (2, 130, 0, None, True),        # 3 q tiles: at rep 1 one item holds a lone tile
    (1, 200, 40, 230, True),        # an offset into a longer cache, kv_len < offset + S
    (1, 330, 0, None, False),       # full attention, 6 q tiles
])
def test_dq_items_cover_every_head_and_tile_heavy_first(rep, b, s, q_offset, kv_len, causal):
    """`dq_items` (the kernel's numbering of the dq work items): every
    (batch, head, q tile) appears in exactly one slot; at rep 1 an item's
    slots are adjacent tiles of one head (the lone tile 0 of an odd tile
    count in the second slot); at rep >= 2 one tile of two neighbouring
    heads of one GQA group; each item streams exactly the kv tiles its
    slots' rows see; and n_tiles never increases along the order."""
    hkv = 2 if rep < 16 else 1
    h, n_qt = rep * hkv, -(-s // 64)
    kv_len_ = s if kv_len is None else kv_len
    items = dq_items(b, h, hkv, s, kv_len=kv_len, q_offset=q_offset, causal=causal)

    def kv_tiles(qt):                   # the kv tiles rows [64 qt, 64 qt + 64) see
        end = min(kv_len_, q_offset + min(64 * qt + 64, s)) if causal else kv_len_
        return -(-end // 64)

    seen = [(it.b, *slot) for it in items for slot in it.slots if slot is not None]
    assert sorted(seen) == [(bb, hh, qt) for bb in range(b) for hh in range(h)
                            for qt in range(n_qt)]
    for it in items:
        first, second = it.slots
        if rep == 1 and first is None:
            assert second[1] == 0 and n_qt % 2
        elif rep == 1:
            assert first[0] == second[0] and first[1] + 1 == second[1]
        elif second is not None:
            assert (second[0], second[1]) == (first[0] + 1, first[1])
            assert second[0] // rep == first[0] // rep
        assert it.n_tiles == max(kv_tiles(slot[1]) for slot in it.slots if slot is not None)
    assert all(a.n_tiles >= z.n_tiles for a, z in zip(items, items[1:]))
    # at rep 1 a warpgroup idles in at most one item per (batch, head)
    idle = [it for it in items if None in it.slots]
    assert len(idle) == (b * h * (n_qt % 2) if rep == 1 else
                         b * hkv * n_qt * (rep % 2))


@pytest.mark.parametrize("b,h,hkv,s,t,q_offset,kv_len", [
    (2, 4, 4, 48, 48, 0, 48),       # MHA, as stablelm-3b
    (1, 6, 2, 20, 64, 30, 50),      # GQA, q_offset, kv_len < T
])
def test_flash_backward_at_head_dim_80_on_cpu_is_the_unpadded_plain_backward(
        b, h, hkv, s, t, q_offset, kv_len):
    """`flash_attention_bwd` on CPU tensors at D = 80 (on the card every
    pass takes D = 80 as it is) is the plain backward of the attention, of
    80 columns: the same values as `attention_bwd_ref`, and autograd's
    gradient of the plain forward in fp32 (1e-5)."""
    g = torch.Generator().manual_seed(33)
    q, do = (torch.randn(b, h, s, 80, generator=g) for _ in range(2))
    k, v = (torch.randn(b, hkv, t, 80, generator=g) for _ in range(2))
    kw = dict(q_offset=q_offset, kv_len=kv_len)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for a, want in zip(got, attention_bwd_ref(q, k, v, out, lse, do, **kw)):
        assert a.shape[-1] == 80
        torch.testing.assert_close(a, want, rtol=0, atol=0)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_out, _ = attention_with_lse_ref(*leaves, 1.0 / math.sqrt(80), **kw)
    for a, want in zip(got, torch.autograd.grad(ref_out, leaves, do)):
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# reduced stablelm-3b at head dim 80 against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced(d_head=80)
    cfg = get_config(ARCH).reduced(d_head=80)
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return {"jcfg": jcfg, "cfg": cfg, "jax": {"bf16": jp, "f32": jp32},
            "torch": {d: from_jax_params(jax.tree_util.tree_map(np.asarray, p), cfg)
                      for d, p in (("bf16", jp), ("f32", jp32))}}


def _batch(seed, vocab, b=2, s=48):
    """tokens/labels shifted by one, and a loss mask with padded tails."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    for i in range(b):
        n = int(rng.integers(s // 2, s + 1))
        toks[i, n + 1:] = 0
        mask[i, n:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": mask}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_d80_loss_and_every_grad_match_jax(model, dt):
    jcfg, cfg = model["jcfg"], model["cfg"]
    assert cfg.head_dim == 80
    batch = _batch(33, cfg.vocab_size)
    vg = jax.value_and_grad(jax_loss_fn, has_aux=True)
    if dt == "bf16":
        vg = jax.jit(vg, static_argnums=(2,), compiler_options=STRICT_BF16)
    (jl, _), jg = vg(model["jax"][dt], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, model["jax"][dt]), cfg)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = loss_fn(params, {"tokens": torch.as_tensor(batch["tokens"]).long(),
                               "labels": torch.as_tensor(batch["labels"]).long(),
                               "loss_mask": torch.as_tensor(batch["loss_mask"])}, cfg)
    tg = to_jax_params(tree_unflatten(params, list(torch.autograd.grad(loss, leaves))), cfg)
    rel = 1e-4 if dt == "f32" else 3e-2
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=rel, atol=rel)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree_util.tree_leaves(tg)):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        atol = rel if dt == "f32" else rel * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=rel if dt == "f32" else 0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_d80_prefill_and_decode_match_jax(model, dt):
    """Prefill logits of [2, 16] prompts, then 8 decode steps fed the same
    tokens on both sides, each step's logits and the final cache compared."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jp, tp = model["jax"][dt], model["torch"][dt]
    tol = TOL_BF16 if dt == "bf16" else dict(rtol=1e-2, atol=1e-2)
    toks = np.random.default_rng(34).integers(0, cfg.vocab_size, (B, S + 8)).astype(np.int32)
    jprefill = jax.jit(jax_prefill, static_argnums=(2,), compiler_options=STRICT_BF16)
    jdecode = jax.jit(jax_decode_step, static_argnums=(2,), compiler_options=STRICT_BF16)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                      jax_init_cache(jcfg, B, MAX_LEN))
    with torch.inference_mode():
        tl, tc = prefill(tp, {"tokens": torch.as_tensor(toks[:, :S]).long()}, cfg,
                         init_cache(cfg, B, MAX_LEN, "cpu"))
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    for i in range(8):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, {"tokens": jnp.asarray(step)}, jcfg, jc, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = decode_step(tp, {"tokens": torch.as_tensor(step).long()}, cfg, tc, S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol, err_msg=f"step {i}")
    assert tuple(tc["kv"]["k"].shape[-1:]) == (80,)
    np.testing.assert_allclose(_np(tc["kv"]["k"]), _np(jc["kv"]["k"]), **tol)

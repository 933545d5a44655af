"""The port's kernels, plain versions against the JAX side, on the CPU.

Each kernel wrapper of `repro_torch.kernels` runs its plain PyTorch version
on a CPU tensor.  The same numpy inputs go through that and through the JAX
oracle (`ref.py`) and the Pallas kernel in interpret mode, as
`tests/test_kernels.py` runs them.  Tolerances are that file's: TOL for
fp32, TOL_BF16 for bf16, 1e-2 for rmsnorm.  The gradients (flash attention,
RMSNorm, cross-entropy) go through the port's autograd ops, whose backward
runs the backward kernels' plain versions on the CPU, against `jax.grad` of
the JAX oracles, and the flash backward's plain passes against the Pallas
backward in interpret mode.  The CUDA kernels themselves are checked
against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from repro.kernels.cross_entropy import ce_ref as jax_ce_ref
from repro.kernels.cross_entropy import fused_ce as jax_fused_ce
from repro.kernels.decode_attention import decode_attention as jax_decode_kernel
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.ref import lse_ref as jax_lse_ref
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm_kernel
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro.models.layers import blocked_causal_attention as jax_blocked
from repro_torch.convert import to_tensor
from repro_torch.kernels import (attention_bwd_ref, attention_ref, ce_ref, decode_attention,
                                 flash_attention, flash_attention_bwd, flash_attention_fwd,
                                 fused_ce, fused_ce_op, lse_ref, rmsnorm, rmsnorm_bwd,
                                 rmsnorm_op)
from repro_torch.models.layers import blocked_causal_attention

TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _rand(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return TOL if dtype is np.float32 else TOL_BF16


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 128), (4, 32, 128), (2, 16, 512)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_plain_matches_jax(shape, dt):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, DTYPES[dt])
    sc = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(DTYPES[dt])
    out = rmsnorm(to_tensor(x), to_tensor(sc))
    assert out.dtype == to_tensor(x).dtype
    for ref in (jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(sc)),
                jax_rmsnorm_kernel(jnp.asarray(x), jnp.asarray(sc), interpret=True)):
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 2, 2, 64, 32),     # MHA
    (2, 4, 2, 128, 32),    # GQA rep=2
    (1, 8, 1, 128, 64),    # MQA
    (1, 4, 4, 96, 16),     # non-pow2 seq (3 Pallas blocks of 32)
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_jax(b, h, hkv, s, d, dt):
    """Sq == T and q_offset = 0: the one case where the Pallas kernel
    (top-left causal), the JAX oracle (bottom-right) and the port agree."""
    rng = np.random.default_rng(1)
    q = _rand(rng, (b, h, s, d), DTYPES[dt])
    k = _rand(rng, (b, hkv, s, d), DTYPES[dt])
    v = _rand(rng, (b, hkv, s, d), DTYPES[dt])
    out, lse = flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kout, klse = jax_flash_kernel(jq, jk, jv, block_q=32, block_kv=32, interpret=True)
    for ref in (jax_attention_ref(jq, jk, jv), kout):
        np.testing.assert_allclose(_np(out), _np(ref), **_tol(DTYPES[dt]))
    for ref in (jax_lse_ref(jq, jk), klse):
        np.testing.assert_allclose(_np(lse), _np(ref), rtol=1e-2, atol=1e-2)
    # the oracle-shaped plain functions give the same, in the oracle's alignment
    tq, tk, tv = to_tensor(q), to_tensor(k), to_tensor(v)
    np.testing.assert_array_equal(_np(attention_ref(tq, tk, tv)), _np(out))
    np.testing.assert_array_equal(_np(lse_ref(tq, tk)), _np(lse))


def test_flash_plain_noncausal_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, (1, 2, 64, 32), np.float32) for _ in range(3))
    out, _ = flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v),
                                 causal=False)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_tail_s100_matches_oracle(dt):
    """S = 100 is not a multiple of any tile.  The Pallas kernel drops the
    tail rows (its grid is s // block), so the port is held to the oracle."""
    rng = np.random.default_rng(4)
    q = _rand(rng, (2, 4, 100, 32), DTYPES[dt])
    k = _rand(rng, (2, 2, 100, 32), DTYPES[dt])
    v = _rand(rng, (2, 2, 100, 32), DTYPES[dt])
    out, lse = flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v))
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    np.testing.assert_allclose(
        _np(out), _np(jax_attention_ref(jq, jk, jnp.asarray(v))), **_tol(DTYPES[dt]))
    np.testing.assert_allclose(_np(lse), _np(jax_lse_ref(jq, jk)), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("q_offset,s,t,kv_len", [
    (16, 16, 48, 32),      # chunked prefill: 16 cached rows, cache longer than kv_len
    (40, 8, 64, 48),       # GQA at a deep offset
    (0, 24, 40, 24),       # first prefill into a longer cache
])
def test_flash_plain_q_offset_matches_blocked_attention(q_offset, s, t, kv_len):
    """q_offset > 0 with kv_len > S: held to the model's plain attention
    (absolute positions), in JAX and in the port."""
    rng = np.random.default_rng(5)
    b, h, hkv, d = 2, 4, 2, 32
    q = _rand(rng, (b, s, h, d), np.float32)
    k = _rand(rng, (b, t, hkv, d), np.float32)
    v = _rand(rng, (b, t, hkv, d), np.float32)
    out, _ = flash_attention_fwd(to_tensor(q).transpose(1, 2),
                                 to_tensor(k).transpose(1, 2),
                                 to_tensor(v).transpose(1, 2),
                                 q_offset=q_offset, kv_len=kv_len)
    out = out.transpose(1, 2)
    scale = 1.0 / np.sqrt(d)
    ref = jax_blocked(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                      jnp.asarray(v[:, :kv_len]), scale, q_offset=q_offset)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    port = blocked_causal_attention(to_tensor(q), to_tensor(k[:, :kv_len]),
                                    to_tensor(v[:, :kv_len]), scale, q_offset=q_offset)
    np.testing.assert_allclose(_np(out), _np(port), **TOL)


def test_flash_plain_bottom_right_default_matches_jax_oracle():
    """Sq < T with the oracle's own alignment (q_offset = T - S)."""
    rng = np.random.default_rng(6)
    q = _rand(rng, (1, 4, 16, 32), np.float32)
    k = _rand(rng, (1, 2, 48, 32), np.float32)
    v = _rand(rng, (1, 2, 48, 32), np.float32)
    out, lse = flash_attention_fwd(to_tensor(q), to_tensor(k), to_tensor(v),
                                   q_offset=48 - 16)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    np.testing.assert_allclose(_np(out), _np(jax_attention_ref(jq, jk, jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(_np(lse), _np(jax_lse_ref(jq, jk)), **TOL)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,hkv,t,d,bkv", [
    (2, 8, 2, 64, 32, 16),
    (1, 4, 4, 128, 64, 32),
    (4, 16, 1, 64, 32, 64),   # MQA, single block
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_plain_matches_jax(b, h, hkv, t, d, bkv, dt):
    rng = np.random.default_rng(7)
    q = _rand(rng, (b, h, d), DTYPES[dt])
    k = _rand(rng, (b, t, hkv, d), DTYPES[dt])
    v = _rand(rng, (b, t, hkv, d), DTYPES[dt])
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)  # JAX gives NaN at 0
    out = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths))
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lengths))
    for ref in (jax_decode_ref(jq, jk, jv, jl),
                jax_decode_kernel(jq, jk, jv, jl, block_kv=bkv, interpret=True)):
        np.testing.assert_allclose(_np(out), _np(ref), **_tol(DTYPES[dt]))


def test_decode_plain_ragged_lengths_poisoned_cache():
    """Each sequence attends only within its own length: poisoning the
    cache past each length changes nothing, as in the JAX test."""
    b, h, hkv, t, d = 3, 4, 2, 64, 32
    rng = np.random.default_rng(8)
    q = _rand(rng, (b, h, d), np.float32)
    k = _rand(rng, (b, t, hkv, d), np.float32)
    v = _rand(rng, (b, t, hkv, d), np.float32)
    lengths = np.array([1, 17, 64], np.int32)
    out = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths))
    k2, v2 = k.copy(), v.copy()
    k2[0, 1:] = 1e4
    k2[1, 17:] = -1e4
    v2[0, 1:] = 1e4
    out2 = decode_attention(to_tensor(q), to_tensor(k2), to_tensor(v2), to_tensor(lengths))
    np.testing.assert_allclose(_np(out), _np(out2), **TOL)
    ref = jax_decode_ref(*(jnp.asarray(a) for a in (q, k, v, lengths)))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_decode_plain_length_zero_gives_zeros():
    """The port defines length 0 as zeros (the JAX oracle gives NaN)."""
    rng = np.random.default_rng(9)
    q = _rand(rng, (2, 4, 32), np.float32)
    k = _rand(rng, (2, 16, 2, 32), np.float32)
    v = _rand(rng, (2, 16, 2, 32), np.float32)
    lengths = np.array([0, 5], np.int32)
    out = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths))
    assert np.all(_np(out)[0] == 0)
    ref = jax_decode_ref(*(jnp.asarray(a) for a in (q[1:], k[1:], v[1:], lengths[1:])))
    np.testing.assert_allclose(_np(out)[1:], _np(ref), **TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_plain_lse_is_the_logsumexp_of_the_masked_scores(dt):
    """The plain version's lse (what the merge of a sequence-split cache's
    partials reads): each row's log-sum-exp of its scaled fp32 scores over
    the first `length` rows, within 1e-5 of a numpy one, -inf at length 0;
    the output comes with it in fp32 and, rounded, is the output without."""
    b, h, hkv, t, d = 3, 8, 2, 40, 32
    rng = np.random.default_rng(11)
    q = _rand(rng, (b, h, d), DTYPES[dt])
    k = _rand(rng, (b, t, hkv, d), DTYPES[dt])
    v = _rand(rng, (b, t, hkv, d), DTYPES[dt])
    lengths = np.array([0, 17, 40], np.int32)
    out, lse = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths),
                                return_lse=True)
    assert lse.dtype == out.dtype == torch.float32 and tuple(lse.shape) == (b, h)
    assert torch.equal(out.to(to_tensor(q).dtype),
                       decode_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                                        to_tensor(lengths)))
    qf, kf = q.astype(np.float32), k.astype(np.float32)
    rep = h // hkv
    scores = np.einsum("bgrd,btgd->bgrt", qf.reshape(b, hkv, rep, d), kf) / np.sqrt(d)
    for i, n in enumerate(lengths):
        got = lse.numpy()[i]
        if n == 0:
            assert np.all(got == -np.inf)
            continue
        s = scores[i, ..., :n].astype(np.float64)
        m = s.max(-1, keepdims=True)
        want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(h)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_plain_t_not_multiple_of_tile():
    """T = 100: the Pallas kernel asserts T % block == 0; held to the oracle."""
    rng = np.random.default_rng(10)
    q = _rand(rng, (2, 8, 32), ml_dtypes.bfloat16)
    k = _rand(rng, (2, 100, 2, 32), ml_dtypes.bfloat16)
    v = _rand(rng, (2, 100, 2, 32), ml_dtypes.bfloat16)
    lengths = np.array([100, 37], np.int32)
    out = decode_attention(to_tensor(q), to_tensor(k), to_tensor(v), to_tensor(lengths))
    ref = jax_decode_ref(*(jnp.asarray(a) for a in (q, k, v, lengths)))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL_BF16)


# ---------------------------------------------------------------------------
# backward passes and autograd ops
# ---------------------------------------------------------------------------
def _leaf(x):
    return to_tensor(x).requires_grad_(True)


@pytest.mark.parametrize("shape", [(8, 128), (2, 16, 512)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_grad_matches_jax(shape, dt):
    """rmsnorm_op's gradient (x and scale) against jax.grad(rmsnorm_ref),
    and rmsnorm_bwd's plain version against the same."""
    rng = np.random.default_rng(10)
    x = _rand(rng, shape, DTYPES[dt], 3.0)
    sc = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(DTYPES[dt])
    dy = _rand(rng, shape, DTYPES[dt])
    jdx, jds = jax.grad(lambda a, b: jnp.sum(jax_rmsnorm_ref(a, b).astype(jnp.float32)
                                             * jnp.asarray(dy, jnp.float32)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sc))
    xt, st = _leaf(x), _leaf(sc)
    dx, ds = torch.autograd.grad(rmsnorm_op(xt, st), (xt, st), to_tensor(dy))
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype
    tol = _tol(DTYPES[dt])
    np.testing.assert_allclose(_np(dx), _np(jdx), **tol)
    np.testing.assert_allclose(_np(ds), _np(jds), rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, float(np.abs(_np(jds)).max())))
    bx, bs = rmsnorm_bwd(to_tensor(x), to_tensor(sc), to_tensor(dy))
    np.testing.assert_array_equal(_np(bx), _np(dx))
    np.testing.assert_array_equal(_np(bs), _np(ds))


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 8, 16, 32])
def test_dkv_cluster_split_covers_every_query_head_once(rep):
    """The dk/dv pass's cluster of blocks (chosen, and each size it takes)
    walks every query head of a GQA group exactly once, so the cluster's sum
    is the group's sum."""
    from repro_torch.kernels.flash_attention.kernel import (DKV_CLUSTERS, dkv_cluster_size,
                                                            dkv_heads)
    for blocks in (1, 16, 128, 1024):
        assert dkv_cluster_size(rep, blocks) in DKV_CLUSTERS
        assert dkv_cluster_size(rep, blocks) <= rep
    assert dkv_cluster_size(16, 8 * 2 * 8) == 2       # the train step: 256 blocks
    for c in DKV_CLUSTERS:
        heads = [h for rank in range(c) for h in dkv_heads(rep, c, rank)]
        assert sorted(heads) == list(range(rep))
        sizes = [len(dkv_heads(rep, c, rank)) for rank in range(c)]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("b,h,hkv,s,d,blk", [
    (1, 2, 2, 64, 32, 32),      # MHA, two Pallas blocks
    (2, 4, 2, 64, 32, 32),      # GQA rep=2
    (1, 8, 1, 96, 16, 32),      # MQA, three blocks
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_plain_matches_pallas_interpret(b, h, hkv, s, d, blk, dt):
    """S == T, q_offset 0: the plain passes against flash_attention_bwd
    (interpret=True) on the forward's own out and lse."""
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, (b, n, s, d), DTYPES[dt]) for n in (h, hkv, hkv))
    do = _rand(rng, (b, h, s, d), DTYPES[dt])
    jo, jl = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=blk, block_kv=blk, interpret=True)
    jq, jk, jv = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
                               jnp.asarray(do), block_q=blk, block_kv=blk, interpret=True)
    tq, tk, tv = flash_attention_bwd(*(to_tensor(np.asarray(a)) for a in
                                       (q, k, v, jo, jl, do)))
    tol = _tol(DTYPES[dt])
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    rq, rk, rv = attention_bwd_ref(*(to_tensor(np.asarray(a)) for a in (q, k, v, jo, jl, do)),
                                   q_offset=0)
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 2, 64, 32), (2, 4, 2, 48, 32),
                                         (1, 8, 1, 100, 64)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_grad_matches_jax_grad_of_attention_ref(b, h, hkv, s, d, dt):
    """The autograd op `flash_attention` (forward, then the dq and dk/dv
    passes) against jax.grad of attention_ref, S == T (S = 100: a tail)."""
    rng = np.random.default_rng(12)
    q, k, v = (_rand(rng, (b, n, s, d), DTYPES[dt]) for n in (h, hkv, hkv))
    do = _rand(rng, (b, h, s, d), DTYPES[dt])

    def jloss(q_, k_, v_):
        return jnp.sum(jax_attention_ref(q_, k_, v_).astype(jnp.float32)
                       * jnp.asarray(do, jnp.float32))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = flash_attention(tq, tk, tv)
    np.testing.assert_allclose(_np(out), _np(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                               jnp.asarray(v))),
                               **_tol(DTYPES[dt]))
    tg = torch.autograd.grad(out, (tq, tk, tv), to_tensor(do))
    tol = _tol(DTYPES[dt])
    for got, want in zip(tg, jg):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(_np(want)).max())))


def _ce_inputs(seed, r, v, dtype):
    rng = np.random.default_rng(seed)
    logits = _rand(rng, (r, v), dtype, 2.0)
    labels = rng.integers(0, v, r).astype(np.int32)
    mask = (rng.random(r) > 0.25).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("r,v,block_rows,block_v", [(16, 4096, 8, 2048), (32, 512, 16, 512)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ce_plain_matches_jax_and_pallas_interpret(r, v, block_rows, block_v, dt):
    """Vocabs the Pallas kernel's tile divides: the plain version against
    JAX ce_ref and fused_ce(interpret=True)."""
    logits, labels, mask = _ce_inputs(13, r, v, DTYPES[dt])
    nll, lse = fused_ce(to_tensor(logits), to_tensor(labels), to_tensor(mask))
    got = float(nll.sum())
    assert float(ce_ref(to_tensor(logits), to_tensor(labels), to_tensor(mask))) == \
        pytest.approx(got, rel=1e-6)
    np.testing.assert_allclose(_np(lse), np.asarray(jax.nn.logsumexp(
        jnp.asarray(logits, jnp.float32), axis=-1)), **TOL)
    args = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    for want in (jax_ce_ref(*args),
                 jax_fused_ce(*args, block_rows=block_rows, block_v=block_v, interpret=True)):
        assert got == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("v", [65024, 50304, 1000])
def test_ce_plain_at_vocabs_the_pallas_tile_does_not_divide(v):
    """chatglm3-6b's and stablelm-3b's full vocabs (65024 = 31.75 x 2048,
    50304) are refused by the Pallas kernel's tiling; the plain version
    (and the CUDA kernel, which masks no tile) is held to JAX ce_ref."""
    logits, labels, mask = _ce_inputs(14, 8, v, ml_dtypes.bfloat16)
    got = float(fused_ce(to_tensor(logits), to_tensor(labels), to_tensor(mask))[0].sum())
    want = float(jax_ce_ref(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("r,v", [(16, 4096), (8, 65024)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ce_grad_matches_jax_grad_of_ce_ref(r, v, dt):
    logits, labels, mask = _ce_inputs(15, r, v, DTYPES[dt])
    jg = jax.grad(jax_ce_ref)(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tl = _leaf(logits)
    loss = fused_ce_op(tl, to_tensor(labels).long(), to_tensor(mask))
    (tg,) = torch.autograd.grad(loss * 3.0, tl)      # a scale other than 1 reaches g
    assert tg.dtype == tl.dtype
    np.testing.assert_allclose(_np(tg), 3.0 * _np(jg), **_tol(DTYPES[dt]))
    assert not _np(tg)[mask == 0].any()               # masked rows get no gradient


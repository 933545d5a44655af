"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
On the card they run with `python -m pytest -q -m cuda tests/test_torch_cuda.py`
(this file imports no JAX).  Each kernel is compared with its plain version
on the same bf16 inputs at TOL_BF16 (1e-2 for rmsnorm and lse), and each
wrapper's launch counter must rise.  The backward kernels are held to their
plain versions on the same inputs: flash dq/dk/dv and the CE gradient at
TOL_BF16, the RMSNorm gradients at TOL_BF16 for dx and at 2e-2 relative to
the largest |dscale| for dscale (a sum over thousands of rows, taken in
another order than the plain version's).  The SSD scan's y and final state
(fp32 outputs of fp32 sums taken in another order and chunking than the
plain version's) at TOL_BF16, and so every gradient of its backward (bf16
dx, dB, dC; fp32 ddt, da_log, dh0) against the plain version at the
kernel's chunk; da_log, a sum over every row of a head, relative to its
largest |value|; at the train shapes every gradient also within 1e-3
relative L2 of fp64 autograd.  The flash passes at q/k head dim 192 and v
head dim 128 (MLA's expanded branch), the reduced deepseek-v2-lite-16b
and deepseek-v3-671b train steps, and deepseek-v3-671b's RMSNorm and CE
shapes are held by chip_smoke.py's own functions (`mla_flash_check`,
`train_check`, `rmsnorm_check`, `rmsnorm_bwd_check`, `ce_check`): one rule
for the card tests and the smoke run.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, decode_attention_ref,
                                 flash_attention_bwd_dkv, flash_attention_bwd_dq,
                                 flash_attention_fwd, fused_ce, fused_ce_bwd, rmsnorm,
                                 rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref, ssd_scan,
                                 ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.cross_entropy import ce_bwd_ref, ce_rows_ref
from repro_torch.kernels.flash_attention import (attention_bwd_dkv_ref, attention_bwd_dq_ref,
                                                 attention_with_lse_ref)
from repro_torch.kernels.decode_attention.kernel import CLUSTERS as DECODE_CLUSTERS
from repro_torch.kernels.flash_attention.kernel import DKV_CLUSTERS
from repro_torch.kernels.ssd_scan.kernel import KERNEL_CHUNK

TOL_BF16 = dict(rtol=3e-2, atol=3e-2)

pytestmark = pytest.mark.cuda


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, scale=1.0):
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(x).to(dev, torch.bfloat16)


def _close(a, b, **tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.detach().float().cpu().numpy(),
                               b.detach().float().cpu().numpy(), **tol)


@pytest.mark.parametrize("shape", [(8, 128), (4, 32, 128), (3, 4096), (2048, 4096),
                                   (4, 768), (4, 2560), (4096, 4096),
                                   (1061, 4096),     # not a multiple of the persistent grid
                                   (333, 136), (5, 8192), (3, 16384), (300, 16384),
                                   (2, 32768), (7, 8),
                                   # jamba-1.5-large-398b's d 8192 and d_inner 16384
                                   (2048, 8192), (2048, 16384), (4, 8192), (4, 16384),
                                   # pixtral-12b's d 5120: prefill and decode rows
                                   (2048, 5120), (4, 5120)])
def test_rmsnorm_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, dev, 3.0)
    sc = 1.0 + 0.1 * _rand(rng, (shape[-1],), dev)
    before = rmsnorm.launches
    out = rmsnorm(x, sc)
    assert rmsnorm.launches == before + 1
    _close(out, rmsnorm_ref(x, sc), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rows,d,pitch", [(2048, 512, 576), (4, 512, 576), (1, 512, 576),
                                           (300, 64, 80), (9, 4096, 4104)])
def test_rmsnorm_kernel_reads_rows_at_a_pitch(dev, rows, d, pitch):
    """The first d columns of rows `pitch` apart (MLA's kv_norm: 512 of each
    576-column projection row), read in place: one launch, a contiguous
    output, the plain version's values."""
    rng = np.random.default_rng(1)
    full = _rand(rng, (rows, pitch), dev, 3.0)
    x = full[:, :d]
    sc = 1.0 + 0.1 * _rand(rng, (d,), dev)
    before = rmsnorm.launches
    out = rmsnorm(x, sc)
    assert rmsnorm.launches == before + 1 and out.is_contiguous()
    _close(out, rmsnorm_ref(x, sc), rtol=1e-2, atol=1e-2)
    if rows >= 4:        # as the model passes it: [B, S, 512] of a [B, S, 576] projection
        x3 = full[: rows - rows % 4].view(4, -1, pitch)[..., :d]
        _close(rmsnorm(x3, sc), rmsnorm_ref(x3, sc), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,h,hkv,s,t,d,q_offset,kv_len,causal", [
    (2, 4, 2, 128, 128, 64, 0, 128, True),     # GQA, whole tiles
    (1, 8, 1, 100, 100, 128, 0, 100, True),    # MQA, S not a multiple of 64
    (2, 32, 2, 130, 300, 128, 40, 170, True),  # chunked prefill into a longer cache
    (1, 2, 2, 64, 64, 32, 0, 64, False),       # full attention
    (4, 32, 2, 512, 1024, 128, 0, 512, True),  # serve-path prefill shape
    (1, 6, 2, 200, 200, 64, 0, 200, True),     # rep 3, S not a multiple of 128
    (2, 4, 4, 100, 100, 128, 0, 100, True),    # MHA (rep 1), S = 100
    (1, 4, 2, 200, 200, 32, 0, 200, True),     # D 32 in a 128-row tile
    (2, 6, 2, 100, 256, 64, 40, 140, True),    # kv_len < T, q_offset 40: TMA's edge
    (1, 8, 2, 200, 200, 64, 0, 200, False),    # full attention, D 64
    (4, 64, 8, 512, 1024, 128, 0, 512, True),  # jamba-1.5-large-398b's prefill: rep 8
    (2, 16, 2, 130, 300, 128, 40, 170, True),  # rep 8 into a longer cache
    (4, 48, 4, 512, 1024, 128, 0, 512, True),  # starcoder2-15b's prefill: rep 12
    (2, 24, 2, 130, 300, 128, 40, 170, True),  # rep 12 into a longer cache
    (4, 32, 8, 512, 1024, 128, 0, 512, True),  # pixtral-12b's prefill: rep 4 at D 128
    (4, 32, 32, 512, 1024, 64, 0, 512, True),  # musicgen-large's prefill: D 64 MHA
    (8, 32, 32, 512, 512, 64, 0, 512, True),   # musicgen-large's train step
])
def test_flash_kernel_matches_plain(dev, b, h, hkv, s, t, d, q_offset, kv_len, causal):
    rng = np.random.default_rng(1)
    # the model's layout: [B,S,H,D] buffers seen as [B,H,S,D] views
    q = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    k = _rand(rng, (b, t, hkv, d), dev).transpose(1, 2)
    v = _rand(rng, (b, t, hkv, d), dev).transpose(1, 2)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = attention_with_lse_ref(q, k, v, causal=causal,
                                          q_offset=q_offset, kv_len=kv_len)
    _close(out, ref, **TOL_BF16)
    _close(lse, ref_lse, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,h,hkv,t,d,lengths", [
    (4, 32, 2, 1024, 128, [1, 64, 65, 1024]),   # serve-path shape, ragged
    (3, 4, 2, 100, 64, [0, 37, 100]),           # length 0 and T % 64 != 0
    (2, 16, 1, 256, 32, [200, 1]),              # MQA
    (4, 32, 2, 1024, 128, [513, 540, 561, 576]),  # chatglm3-6b's serve lengths
    (4, 32, 32, 1024, 80, [513, 540, 561, 576]),  # stablelm-3b's: D 80, rep 1
    (3, 8, 8, 100, 80, [0, 17, 100]),           # D 80: length 0, ragged tails
    (2, 24, 1, 300, 80, [299, 33]),             # D 80, rep 24: two 16-head tiles
    (2, 128, 1, 96, 32, [96, 5]),               # rep 128 at D 32: four head chunks
    (1, 32, 1, 2048, 128, [2047]),              # rep 32, long
    (4, 64, 8, 1024, 128, [513, 540, 561, 576]),  # jamba-1.5-large-398b's: rep 8
    (3, 16, 2, 100, 128, [0, 64, 99]),          # rep 8: length 0, ragged tails
    (4, 48, 4, 1024, 128, [513, 540, 561, 576]),  # starcoder2-15b's: rep 12
    (3, 24, 2, 100, 128, [0, 64, 99]),          # rep 12: length 0, ragged tails
    (4, 32, 8, 1024, 128, [513, 540, 561, 576]),  # pixtral-12b's: rep 4 at D 128
    (4, 32, 32, 1024, 64, [513, 540, 561, 576]),  # musicgen-large's: D 64, rep 1
    (3, 8, 8, 100, 64, [0, 17, 100]),           # D 64, rep 1: length 0, ragged tails
])
def test_decode_kernel_matches_plain(dev, b, h, hkv, t, d, lengths):
    rng = np.random.default_rng(2)
    q = _rand(rng, (b, h, d), dev)
    k = _rand(rng, (b, t, hkv, d), dev)
    v = _rand(rng, (b, t, hkv, d), dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    assert decode_attention.launches == before + 1
    _close(out, decode_attention_ref(q, k, v, lens), **TOL_BF16)
    # rows past each length are never read: poisoning them changes nothing
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        k2[i, n:] = float("nan")
        v2[i, n:] = float("nan")
    _close(decode_attention(q, k2, v2, lens), out, rtol=0, atol=0)


@pytest.mark.parametrize("d,h,hkv", [(128, 32, 2), (80, 32, 32), (64, 6, 2), (128, 64, 8),
                                     # starcoder2-15b's rep 12, pixtral-12b's rep 4,
                                     # musicgen-large's D 64 MHA
                                     (128, 48, 4), (128, 32, 8), (64, 32, 32)])
def test_decode_kernel_every_cluster_size_matches_plain(dev, d, h, hkv):
    """Each cluster size splits the live rows (ranks with no rows when the
    length is short) and combines them to the plain version."""
    rng = np.random.default_rng(17)
    b, t = 4, 1024
    q = _rand(rng, (b, h, d), dev)
    k, v = _rand(rng, (b, t, hkv, d), dev), _rand(rng, (b, t, hkv, d), dev)
    lens = torch.tensor([513, 9, 0, 1000], dtype=torch.int32, device=dev)
    ref = decode_attention_ref(q, k, v, lens)
    for c in DECODE_CLUSTERS:
        _close(decode_attention(q, k, v, lens, cluster=c), ref, **TOL_BF16)


@pytest.mark.parametrize("d,h,hkv", [(128, 32, 2), (80, 32, 32), (64, 6, 2), (128, 64, 8),
                                     (128, 48, 4), (64, 32, 32), (32, 128, 1)])
def test_decode_kernel_lse_matches_plain_at_every_cluster_size(dev, d, h, hkv):
    """The lse output (the merge of a sequence-split cache reads it): each
    row's log-sum-exp of its scaled scores against the plain version's at
    chip_smoke's TOL_LSE, -inf at length 0, at every cluster size, with the
    output in fp32 within TOL_BF16 of the plain version's fp32 one and, rounded, the
    bf16 output's bits, in one launch."""
    rng = np.random.default_rng(19)
    b, t = 4, 1024
    q = _rand(rng, (b, h, d), dev)
    k, v = _rand(rng, (b, t, hkv, d), dev), _rand(rng, (b, t, hkv, d), dev)
    lens = torch.tensor([513, 9, 0, 1000], dtype=torch.int32, device=dev)
    ref_out, ref = decode_attention_ref(q, k, v, lens, return_lse=True)
    tol = _chip_smoke().TOL_LSE
    for c in DECODE_CLUSTERS:
        before = decode_attention.launches
        out, lse = decode_attention(q, k, v, lens, cluster=c, return_lse=True)
        assert decode_attention.launches == before + 1
        assert out.dtype == torch.float32
        _close(out, ref_out, **TOL_BF16)
        assert torch.equal(out.to(q.dtype), decode_attention(q, k, v, lens, cluster=c))
        assert torch.equal(torch.isinf(lse), lens[:, None].expand(b, h) == 0)
        fin = torch.isfinite(ref)
        _close(lse[fin], ref[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("d,hkv", [(128, 2), (80, 32), (128, 8), (64, 32)])
def test_decode_kernel_is_bitwise_repeatable(dev, d, hkv):
    """One launch combines its partials in a fixed order: the same inputs
    give the same bits."""
    rng = np.random.default_rng(18)
    q = _rand(rng, (4, 32, d), dev)
    k, v = _rand(rng, (4, 1024, hkv, d), dev), _rand(rng, (4, 1024, hkv, d), dev)
    lens = torch.tensor([513, 540, 561, 576], dtype=torch.int32, device=dev)
    out = decode_attention(q, k, v, lens)
    for _ in range(3):
        assert torch.equal(decode_attention(q, k, v, lens), out)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 128, device=dev)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(128, device=dev))
    wide = torch.ones(2, 16384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # the backward holds a row in registers
        rmsnorm_bwd(wide, wide[0], wide)
    wider = torch.ones(2, 32776, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):           # and the forward too
        rmsnorm(wider, wider[0])
    q = torch.randn(1, 2, 16, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)          # head dim 48 has no kernel
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2),
                         torch.ones(1, dtype=torch.int64, device=dev))


def test_reduced_server_on_card_matches_cpu(dev):
    """The reduced chatglm3-6b served on the card (kernels) against the
    same weights served on the CPU (plain versions)."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import Server
    from repro_torch.models import init_cache, prefill

    gpu = Server("chatglm3-6b", max_len=64, device=dev, seed=3)
    cpu_params = _map(gpu.params, lambda t: t.cpu())
    cfg = gpu.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.inference_mode():
        lg, _ = prefill(gpu.params, {"tokens": toks.to(dev)}, cfg,
                        init_cache(cfg, 2, 64, dev))
        lc, _ = prefill(cpu_params, {"tokens": toks}, cfg,
                        init_cache(cfg, 2, 64, "cpu"))
    _close(lg, lc, **TOL_BF16)
    reset_launches()
    out = gpu.generate(toks.numpy()[:, :16], 8)
    assert out["finite"]
    n = cfg.n_layers
    assert {k: v for k, v in launches().items() if v} == {
        "rmsnorm": (2 * n + 1) * 9, "flash_attention_fwd": n, "decode_attention": n * 8}


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_reduced_frontend_server_on_card_matches_cpu(dev, arch):
    """A reduced stub-frontend arch served on the card (kernels; the stub
    table built on the card) against the same weights and embeds on the CPU
    (plain versions): the prefill's logits within 3e-2 of their largest
    magnitude (chip_smoke.py's cross-check gate: elementwise at rtol = atol
    = 3e-2, 2 of pixtral-12b's 1024 logits, each near 0, read 0.008 past),
    then Server.generate's launch counts (pixtral-12b's RMS norms;
    musicgen-large's LayerNorm stays plain torch) and the stub table's bits
    on both devices."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import Server
    from repro_torch.models import init_cache, prefill

    gpu = Server(arch, max_len=64, device=dev, seed=3)
    cpu = Server(arch, max_len=64, device="cpu", params=_map(gpu.params, lambda t: t.cpu()))
    assert torch.equal(gpu._stub.cpu(), cpu._stub)
    cfg = gpu.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)))
    with torch.inference_mode():
        lg, _ = prefill(gpu.params, gpu.batch(toks.to(dev)), cfg, init_cache(cfg, 2, 64, dev))
        lc, _ = prefill(cpu.params, cpu.batch(toks), cfg, init_cache(cfg, 2, 64, "cpu"))
    assert float((lg.cpu() - lc).abs().max()) <= 3e-2 * float(lc.abs().max())
    reset_launches()
    out = gpu.generate(toks.numpy()[:, :16], 8)
    assert out["finite"]
    n = cfg.n_layers
    want = {"flash_attention_fwd": n, "decode_attention": n * 8}
    if cfg.norm == "rmsnorm":
        want["rmsnorm"] = (2 * n + 1) * 9
    assert {k: v for k, v in launches().items() if v} == want


@pytest.mark.parametrize("shape", [(8, 128), (3, 4096), (4096, 4096), (2, 100, 256),
                                   (4097, 4096), (1, 4096), (333, 136), (5, 8192),
                                   (7, 8),
                                   (4096, 2048)])     # deepseek-v2-lite-16b's train step
def test_rmsnorm_bwd_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(5)
    x = _rand(rng, shape, dev, 3.0)
    sc = 1.0 + 0.1 * _rand(rng, (shape[-1],), dev)
    dy = _rand(rng, shape, dev)
    before = rmsnorm_bwd.launches
    dx, ds = rmsnorm_bwd(x, sc, dy)
    assert rmsnorm_bwd.launches == before + 1
    rx, rs = rmsnorm_bwd_ref(x, sc, dy)
    _close(dx, rx, **TOL_BF16)
    _close(ds, rs, rtol=0, atol=2e-2 * float(rs.float().abs().max()))
    # dscale is summed in a fixed order: the same inputs give the same bits
    assert torch.equal(rmsnorm_bwd(x, sc, dy)[1], ds)


@pytest.mark.parametrize("b,h,hkv,s,t,d,q_offset,kv_len,causal", [
    (2, 4, 2, 128, 128, 64, 0, 128, True),     # GQA, whole tiles
    (1, 8, 1, 100, 100, 128, 0, 100, True),    # MQA, S not a multiple of 64
    (2, 32, 2, 130, 300, 128, 40, 170, True),  # offset queries into a longer cache
    (1, 2, 2, 64, 64, 32, 0, 64, False),       # full attention
    (8, 32, 2, 512, 512, 128, 0, 512, True),   # the train step's shape
    (1, 6, 2, 200, 200, 64, 0, 200, True),     # rep 3: the cluster does not divide it
    (2, 4, 4, 100, 100, 128, 0, 100, True),    # MHA (rep 1), S = 100
    (1, 4, 2, 200, 200, 32, 0, 200, True),     # D 32, S = 200
    (2, 6, 2, 100, 256, 64, 40, 140, True),    # kv_len < T, q_offset 40
    (2, 4, 4, 130, 130, 80, 0, 130, True),     # rep 1, D 80, 3 q tiles: a lone tile
    (2, 4, 4, 130, 130, 128, 0, 130, True),    # rep 1, D 128, 3 q tiles
    (2, 6, 6, 130, 300, 80, 40, 170, True),    # rep 1, D 80, offset into a longer cache
    (1, 4, 4, 320, 320, 80, 0, 320, False),    # rep 1, D 80, full attention, 5 q tiles
    (2, 8, 2, 100, 256, 80, 40, 140, True),    # rep 4, D 80, kv_len < T
    (2, 8, 1, 192, 192, 128, 0, 192, True),    # train_check_hybrid's rep 8 at D 128
    (8, 64, 8, 512, 512, 128, 0, 512, True),   # a full-width jamba train step's: rep 8
    (8, 48, 4, 512, 512, 128, 0, 512, True),   # starcoder2-15b's train step: rep 12
    (2, 12, 1, 192, 192, 128, 0, 192, True),   # train_check_starcoder2's rep 12 at D 128
    (8, 32, 8, 512, 512, 128, 0, 512, True),   # pixtral-12b's: rep 4 at D 128
    (8, 32, 32, 512, 512, 64, 0, 512, True),   # musicgen-large's: D 64 MHA
])
def test_flash_bwd_kernels_match_plain(dev, b, h, hkv, s, t, d, q_offset, kv_len, causal):
    rng = np.random.default_rng(6)
    q = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    k = _rand(rng, (b, t, hkv, d), dev).transpose(1, 2)
    v = _rand(rng, (b, t, hkv, d), dev).transpose(1, 2)
    do = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    n_dq, n_dkv = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
    dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert flash_attention_bwd_dq.launches == n_dq + 1
    assert flash_attention_bwd_dkv.launches == n_dkv + 1
    rq, rdelta = attention_bwd_dq_ref(q, k, v, out, do, lse, **kw)
    rk, rv = attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, **kw)
    _close(delta, rdelta, rtol=1e-2, atol=1e-2)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        _close(got, want, **TOL_BF16)
    if kv_len < t:      # kv rows past kv_len get zero gradients
        assert not dk[:, :, kv_len:].any() and not dv[:, :, kv_len:].any()


@pytest.mark.parametrize("b,h,hkv,s,t,q_offset,kv_len", [
    (8, 32, 32, 512, 512, 0, 512),      # the stablelm-3b train step's shape
    (4, 32, 32, 512, 1024, 0, 512),     # its serve prefill into the cache
    (2, 4, 2, 100, 256, 40, 140),       # GQA, q_offset, kv_len < T
    (2, 8, 2, 130, 300, 40, 170),       # rep 4: a chunk of prompt into a longer cache
    (1, 4, 4, 65, 65, 0, 65),           # MHA, one row past a tile
    (3, 6, 6, 1, 90, 77, 78),           # one query row at offset 77 of 78 live rows
])
def test_flash_kernels_at_head_dim_80_match_plain(dev, monkeypatch, b, h, hkv, s, t, q_offset,
                                                  kv_len):
    """Head dim 80 (stablelm-3b): the forward, dq and dk/dv kernels take it
    as it is (their entry points have D 80 instances, and each wrapper
    hands its kernel head dim 80 and the caller's q, no padded copy).  The
    three passes against the plain versions at D 80, one launch each, with
    the softmax scale of D 80."""
    from repro_torch.kernels import _build

    smem = {p: _build.function(f"flash_attention_{p}_smem_bytes", (_build.INT,) * 2)(80, 80)
            for p in ("fwd", "bwd_dq", "bwd_dkv")}
    assert all(v > 0 for v in smem.values())
    calls = []                          # (entry, q pointer, head dim) of each kernel call
    function = _build.function

    def recording(entry, argtypes):
        fn = function(entry, argtypes)

        def call(*args):
            calls.append((entry, args[0], args[9 if entry.endswith("fwd_bf16") else 13]))
            return fn(*args)
        return call
    monkeypatch.setattr(_build, "function", recording)
    rng = np.random.default_rng(19)
    q = _rand(rng, (b, s, h, 80), dev).transpose(1, 2)
    k = _rand(rng, (b, t, hkv, 80), dev).transpose(1, 2)
    v = _rand(rng, (b, t, hkv, 80), dev).transpose(1, 2)
    do = _rand(rng, (b, s, h, 80), dev).transpose(1, 2)
    kw = dict(q_offset=q_offset, kv_len=kv_len)
    before = [w.launches for w in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    out, lse = flash_attention_fwd(q, k, v, **kw)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert [w.launches for w in (flash_attention_fwd, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == [n + 1 for n in before]
    assert [(e, ptr, d) for e, ptr, d in calls] == [
        (f"flash_attention_{p}_bf16", q.data_ptr(), 80) for p in ("fwd", "bwd_dq", "bwd_dkv")]
    assert out.shape == dq.shape == q.shape and dk.shape == dv.shape == k.shape
    ref, ref_lse = attention_with_lse_ref(q, k, v, **kw)
    rq, rdelta = attention_bwd_dq_ref(q, k, v, out, do, lse, **kw)
    rk, rv = attention_bwd_dkv_ref(q, k, v, do, lse, rdelta, **kw)
    _close(lse, ref_lse, rtol=1e-2, atol=1e-2)
    _close(delta, rdelta, rtol=1e-2, atol=1e-2)
    for got, want in ((out, ref), (dq, rq), (dk, rk), (dv, rv)):
        _close(got, want, **TOL_BF16)
    if kv_len < t:      # kv rows past kv_len get zero gradients
        assert not dk[:, :, kv_len:].any() and not dv[:, :, kv_len:].any()


def _dkv_inputs(rng, dev, b, h, hkv, s, d):
    q = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    k = _rand(rng, (b, s, hkv, d), dev).transpose(1, 2)
    v = _rand(rng, (b, s, hkv, d), dev).transpose(1, 2)
    do = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v)
    _, delta = flash_attention_bwd_dq(q, k, v, out, do, lse)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("cluster", DKV_CLUSTERS)
@pytest.mark.parametrize("h,hkv", [(6, 2), (16, 1), (16, 2),   # rep 3 (< 4, 8), 16 and 8
                                   # rep 12 (a cluster of 8 gives each rank 1 or 2
                                   # heads) and rep 4 at D 128
                                   (24, 2), (8, 2)])
def test_flash_dkv_every_cluster_size_matches_plain(dev, cluster, h, hkv):
    """Each cluster size splits the GQA group (blocks with no head when
    rep < cluster) and sums it to the plain version's dk/dv."""
    rng = np.random.default_rng(12)
    q, k, v, do, lse, delta = _dkv_inputs(rng, dev, 2, h, hkv, 192, 128)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, cluster=cluster)
    rk, rv = attention_bwd_dkv_ref(q, k, v, do, lse, delta, q_offset=0)
    _close(dk, rk, **TOL_BF16)
    _close(dv, rv, **TOL_BF16)


@pytest.mark.parametrize("cluster", DKV_CLUSTERS)
@pytest.mark.parametrize("h,hkv", [(8, 2), (6, 2), (16, 1)])   # rep 4, 3 and 16
def test_flash_dkv_at_head_dim_80_every_cluster_size_matches_plain(dev, cluster, h, hkv):
    """The native D 80 dk/dv kernel at rep > 1: each cluster size splits the
    GQA group and sums it to the plain version's dk/dv, S = 150 (not a
    multiple of the 64-row tile)."""
    rng = np.random.default_rng(15)
    q, k, v, do, lse, delta = _dkv_inputs(rng, dev, 2, h, hkv, 150, 80)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, cluster=cluster)
    rk, rv = attention_bwd_dkv_ref(q, k, v, do, lse, delta, q_offset=0)
    _close(dk, rk, **TOL_BF16)
    _close(dv, rv, **TOL_BF16)


@pytest.mark.parametrize("d,h,hkv,cluster", [(128, 32, 2, None), (128, 32, 2, 8),
                                             (80, 32, 32, None), (80, 32, 4, 8),
                                             # rep 12: the wrapper's cluster and 8
                                             (128, 48, 4, None), (128, 48, 4, 8)])
def test_flash_dkv_kernel_is_bitwise_repeatable(dev, d, h, hkv, cluster):
    """The cluster sums its partials in rank order: the same inputs give the
    same bits (head dim 128, and 80: stablelm-3b's MHA and a GQA group of 8
    over a cluster of 8)."""
    rng = np.random.default_rng(13)
    args = _dkv_inputs(rng, dev, 2, h, hkv, 512, d)
    dk, dv = flash_attention_bwd_dkv(*args, cluster=cluster)
    for _ in range(3):
        dk2, dv2 = flash_attention_bwd_dkv(*args, cluster=cluster)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("d,hkv", [(128, 2), (80, 32),   # chatglm3-6b's GQA, stablelm-3b's MHA
                                   (128, 4), (64, 32)])  # rep 8 of 32 heads, D 64 MHA
def test_flash_dq_kernel_is_bitwise_repeatable(dev, d, hkv):
    """The dq pass writes each dq row from one warpgroup's registers, with no
    atomics: the same inputs give the same bits, and the same delta (at rep
    1 the two warpgroups of a block take two q tiles of one head)."""
    rng = np.random.default_rng(14)
    b, h, s = 8, 32, 512
    q = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    k = _rand(rng, (b, s, hkv, d), dev).transpose(1, 2)
    v = _rand(rng, (b, s, hkv, d), dev).transpose(1, 2)
    do = _rand(rng, (b, s, h, d), dev).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse)
    for _ in range(3):
        dq2, delta2 = flash_attention_bwd_dq(q, k, v, out, do, lse)
        assert torch.equal(dq2, dq) and torch.equal(delta2, delta)


@pytest.mark.parametrize("r,v", [(512, 65024), (64, 50304), (7, 512),
                                 (512, 50280),      # mamba2-130m's vocab, one of 8 CE chunks
                                 (512, 102400),     # deepseek-v2-lite-16b: whole 1024-col blocks
                                 (512, 256000),     # command-r-35b's tied vocab
                                 (512, 2048)])      # musicgen-large's
def test_fused_ce_kernels_match_plain(dev, r, v):
    rng = np.random.default_rng(7)
    logits = _rand(rng, (r, v), dev, 2.0)
    labels = torch.from_numpy(rng.integers(0, v, r)).to(dev)
    mask = torch.from_numpy((rng.random(r) > 0.2).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.random(r, dtype=np.float32)).to(dev)
    n_f, n_b = fused_ce.launches, fused_ce_bwd.launches
    nll, lse = fused_ce(logits, labels, mask)
    dl = fused_ce_bwd(logits, labels, mask, lse, g)
    assert fused_ce.launches == n_f + 1 and fused_ce_bwd.launches == n_b + 1
    rn, rl = ce_rows_ref(logits, labels, mask)
    _close(lse, rl, rtol=1e-5, atol=1e-4)
    _close(nll, rn, rtol=1e-5, atol=1e-4)
    _close(dl, ce_bwd_ref(logits, labels, mask, rl, g), **TOL_BF16)


def test_reduced_train_step_on_card_matches_cpu(dev):
    """One train step of reduced chatglm3-6b on the card (kernels) against
    the same weights and batch on the CPU (plain versions): loss, every
    gradient and the updated params, at TOL_BF16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model, loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_state, train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config("chatglm3-6b").reduced()
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(8), dev)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 65))
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0
    batches = {}
    for d in (dev, torch.device("cpu")):
        batches[d.type] = {"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                           "labels": torch.from_numpy(toks[:, 1:]).to(d),
                           "loss_mask": torch.from_numpy(mask).to(d)}
    opt_cfg = AdamWConfig(warmup_steps=1, moment_dtype=torch.bfloat16)
    states = {"cuda": make_train_state(cfg, opt_cfg, params=params),
              "cpu": make_train_state(cfg, opt_cfg, params=_map(
                  params, lambda t: t.detach().cpu().clone()))}
    grads = {}
    for d, st in states.items():
        leaves = tree_leaves(st["params"])
        loss, _ = loss_fn(st["params"], batches[d], cfg)
        grads[d] = (loss, torch.autograd.grad(loss, leaves))
    _close(grads["cuda"][0], grads["cpu"][0], **TOL_BF16)
    for a, b in zip(grads["cuda"][1], grads["cpu"][1]):
        _close(a, b, rtol=3e-2, atol=3e-2 * max(1.0, float(b.float().abs().max())))
    reset_launches()
    for d, st in states.items():
        train_step(st, batches[d], cfg, opt_cfg)
    n, c = cfg.n_layers, 8
    assert launches() == {"rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1,
                          "flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                          "flash_attention_bwd_dkv": n, "decode_attention": 0,
                          "fused_ce": 2 * c, "fused_ce_bwd": c, "ssd_scan": 0,
                          "ssd_scan_bwd": 0}
    for a, b in zip(tree_leaves(states["cuda"]["params"]),
                    tree_leaves(states["cpu"]["params"])):
        _close(a, b, **TOL_BF16)


def test_reduced_stablelm_head_dim_80_on_card_matches_cpu(dev):
    """Reduced stablelm-3b at head dim 80 (the full model's; LayerNorm, MHA,
    quarter rotary): the loss and every gradient, then a prefill and 8
    decode steps, on the card (kernels) against the same weights on the CPU
    (plain versions), with the launch counts of both.  The loss and the
    gradients at TOL_BF16, as for chatglm3-6b; the logits at a relative L2
    error <= 3e-2, as the mamba2 server's: the kernels round P to bf16 where
    the plain versions keep fp32, and single logits then move by up to 0.042
    (one of 1024 on the card) through four random layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import decode_step, init_cache, init_model, loss_fn, prefill
    from repro_torch.tree import tree_leaves

    cfg = get_config("stablelm-3b").reduced(d_head=80)
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(20), dev)
    cpu_params = _map(params, lambda t: t.detach().cpu().clone())
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 65))
    mask = np.ones((2, 64), np.float32)
    mask[1, 50:] = 0
    res = {}
    reset_launches()
    for d, p in (("cuda", params), ("cpu", cpu_params)):
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                 "labels": torch.from_numpy(toks[:, 1:]).to(d),
                 "loss_mask": torch.from_numpy(mask).to(d)}
        loss, _ = loss_fn(p, batch, cfg)
        res[d] = (loss, torch.autograd.grad(loss, leaves))
    n = cfg.n_layers
    assert {k: v for k, v in launches().items() if v} == {
        "flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
        "flash_attention_bwd_dkv": n, "fused_ce": 16, "fused_ce_bwd": 8}
    _close(res["cuda"][0], res["cpu"][0], **TOL_BF16)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        _close(a, b, rtol=3e-2, atol=3e-2 * max(1.0, float(b.float().abs().max())))
    for t in tree_leaves(params) + tree_leaves(cpu_params):
        t.requires_grad_(False)
    reset_launches()
    with torch.inference_mode():
        ct = torch.from_numpy(toks[:, :48])
        lg, cg = prefill(params, {"tokens": ct[:, :40].to(dev)}, cfg, init_cache(cfg, 2, 64, dev))
        lc, cc = prefill(cpu_params, {"tokens": ct[:, :40]}, cfg, init_cache(cfg, 2, 64, "cpu"))
        _rel_close(lg, lc, 3e-2)
        for i in range(40, 48):
            lg, cg = decode_step(params, {"tokens": ct[:, i:i + 1].to(dev)}, cfg, cg, i)
            lc, cc = decode_step(cpu_params, {"tokens": ct[:, i:i + 1]}, cfg, cc, i)
            _rel_close(lg, lc, 3e-2)
    assert {k: v for k, v in launches().items() if v} == {
        "flash_attention_fwd": n, "decode_attention": 8 * n}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_reduced_deepseek_server_on_card_matches_cpu(dev, arch, monkeypatch):
    """Reduced deepseek-v2-lite-16b (softmax router) and deepseek-v3-671b
    (sigmoid router, q-LoRA) served on the card (the RMSNorm kernel, kv_norm
    at its row pitch; MLA and MoE plain torch, as JAX's jnp) against the same
    weights on the CPU: prefill and 8 decode steps, then the launch counts
    of Server.generate: every norm of every step, and no other kernel.

    cuBLAS and the CPU round the bf16 products at other places, so the
    router's inputs differ by rounding, and a token whose k-th and (k+1)-th
    selection scores nearly tie may take the other expert on one side; that
    flip moves the logits by the expert's whole share (one flip, at a gap of
    1.1e-3, read a relative L2 error of 7 %: tools/moe_routing_check.py).
    So the CPU run takes the card's selection, weighted by its own scores,
    and its own selection may differ only where the gap is below NEAR_TIE.
    The logits are held at a relative L2 error <= 3e-2, as the mamba2 and
    stablelm-3b servers' (single logits move by up to 0.039)."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import Server
    from repro_torch.models import decode_step, init_cache, layers, prefill

    near_tie = 1e-2
    real_route, picks, flips = layers.moe_route, [], []

    def route(p, xt, cfg):
        scores, top_idx, top_w = real_route(p, xt, cfg)
        if xt.is_cuda:                      # the card runs each step first
            picks.append(top_idx.cpu())
            return scores, top_idx, top_w
        pin, mo = picks.pop(0), cfg.moe
        sel = scores + p["router_bias"] if mo.router == "sigmoid" else scores
        top = torch.sort(sel, dim=-1, descending=True).values
        gap = top[:, mo.top_k - 1] - top[:, mo.top_k]
        for t in range(pin.shape[0]):
            if set(pin[t].tolist()) != set(top_idx[t].tolist()):
                flips.append(float(gap[t]))
        top_w = torch.gather(scores, 1, pin)
        if mo.router == "sigmoid":
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
        return scores, pin, top_w * mo.router_scale

    gpu = Server(arch, max_len=64, device=dev, seed=3)
    cpu_params = _map(gpu.params, lambda t: t.cpu())
    cfg = gpu.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)))
    monkeypatch.setattr(layers, "moe_route", route)
    with torch.inference_mode():
        lg, cg = prefill(gpu.params, {"tokens": toks[:, :40].to(dev)}, cfg,
                         init_cache(cfg, 2, 64, dev))
        lc, cc = prefill(cpu_params, {"tokens": toks[:, :40]}, cfg,
                         init_cache(cfg, 2, 64, "cpu"))
        _rel_close(lg, lc, 3e-2)
        for i in range(40, 48):
            lg, cg = decode_step(gpu.params, {"tokens": toks[:, i:i + 1].to(dev)}, cfg, cg, i)
            lc, cc = decode_step(cpu_params, {"tokens": toks[:, i:i + 1]}, cfg, cc, i)
            _rel_close(lg, lc, 3e-2)
    monkeypatch.undo()
    assert not picks and all(g < near_tie for g in flips), flips
    reset_launches()
    out = gpu.generate(toks.numpy()[:, :16], 8)
    assert out["finite"]
    # attn_norm, kv_norm, ffn_norm a layer (and q_norm with q-LoRA), final_norm
    per_layer = 4 if cfg.mla.q_lora_rank else 3
    assert {k: v for k, v in launches().items() if v} == {
        "rmsnorm": (per_layer * cfg.n_layers + 1) * 9}


def _ssd_inputs(rng, dev, b, s, h, p, n, *, strong=False, strided=False, h0=False):
    """bf16 x, B, C (strided: slices of one [b, s, h p + 2 n] buffer, as the
    model passes them), fp32 dt = softplus(N(0,1)) and a_log, optional h0."""
    if strided:
        buf = _rand(rng, (b, s, h * p + 2 * n), dev)
        x = buf[..., :h * p].reshape(b, s, h, p)
        Bm, Cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    else:
        x, Bm, Cm = _rand(rng, (b, s, h, p), dev), _rand(rng, (b, s, n), dev), \
            _rand(rng, (b, s, n), dev)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h), dtype=np.float32)).to(dev))
    if strong:       # cum falls by ~10^3 inside a chunk: exp(-cum) is inf in fp32
        dt = torch.clamp(dt * 3, max=3.0)
        a_log = torch.full((h,), float(np.log(16.0)), device=dev)
    else:
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    hs = (torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32)).to(dev)
          if h0 else None)
    return x, dt, a_log, Bm, Cm, hs


@pytest.mark.parametrize("b,s,h,p,n,case", [
    (2, 256, 4, 16, 16, "plain"),
    (2, 256, 4, 32, 32, "plain"),
    (1, 512, 3, 64, 128, "plain"),
    (2, 300, 4, 64, 128, "tail"),        # S = 300: a 44-row tail chunk
    (2, 200, 4, 32, 64, "h0"),           # from a nonzero state
    (2, 130, 6, 64, 128, "strided"),     # the model's slices of one conv output
    (1, 256, 4, 64, 128, "strong"),      # a_log = log 16, dt up to 3
    (4, 8192, 24, 64, 128, "strided"),   # the mamba2-130m serve prefill
    (2, 1, 3, 64, 128, "plain"),         # one row
    (2, 63, 3, 64, 128, "plain"),        # one row short of the kernel's 64-row chunk
    (2, 65, 3, 64, 128, "plain"),        # one row past it
    (2, 1, 3, 32, 32, "h0"),             # one row from a nonzero state
    (2, 65, 3, 16, 16, "strong_h0"),     # strong decay from a nonzero state, every P
    (2, 200, 3, 32, 64, "strong_h0"),
    (2, 130, 3, 64, 128, "strong_h0"),
    (4, 512, 256, 64, 16, "strided"),    # jamba-1.5-large-398b's prefill: N 16
    (2, 513, 32, 64, 16, "strided_h0"),  # N 16: a one-row tail from a state
    (2, 65, 8, 64, 16, "strong_h0"),
    (2, 1, 8, 64, 16, "h0"),
])
def test_ssd_scan_kernel_matches_plain(dev, b, s, h, p, n, case):
    rng = np.random.default_rng(10)
    x, dt, a_log, Bm, Cm, h0 = _ssd_inputs(rng, dev, b, s, h, p, n, strong="strong" in case,
                                           strided=case == "strided", h0="h0" in case)
    before = ssd_scan.launches
    with torch.inference_mode():
        y, hf = ssd_scan(x, dt, a_log, Bm, Cm, h0=h0)
        ry, rh = ssd_scan_ref(x, dt, a_log, Bm, Cm, chunk=256, h0=h0)
    assert ssd_scan.launches == before + 1
    assert y.dtype == hf.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    _close(y, ry, **TOL_BF16)
    _close(hf, rh, **TOL_BF16)


def test_ssd_scan_kernel_is_bitwise_repeatable(dev):
    """One block owns a (batch, head) and sums in a fixed order: the same
    inputs give the same bits, at the serve prefill's shape from a state."""
    rng = np.random.default_rng(16)
    x, dt, a_log, Bm, Cm, h0 = _ssd_inputs(rng, dev, 4, 8192, 24, 64, 128, strided=True,
                                           h0=True)
    with torch.inference_mode():
        y, hf = ssd_scan(x, dt, a_log, Bm, Cm, h0=h0)
        for _ in range(2):
            y2, hf2 = ssd_scan(x, dt, a_log, Bm, Cm, h0=h0)
            assert torch.equal(y2, y) and torch.equal(hf2, hf)


def test_ssd_scan_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(11)
    x, dt, a_log, Bm, Cm, _ = _ssd_inputs(rng, dev, 1, 64, 2, 64, 128)
    with pytest.raises(ValueError):                 # head dim 48
        ssd_scan(x[..., :48], dt, a_log, Bm, Cm)
    with pytest.raises(ValueError):                 # d_state 96
        ssd_scan(x, dt, a_log, Bm[..., :96], Cm[..., :96])
    with pytest.raises(TypeError):
        ssd_scan(x.float(), dt, a_log, Bm, Cm)
    with pytest.raises(NotImplementedError):        # differentiable only as ssd_scan_op
        ssd_scan(x, dt.requires_grad_(True), a_log, Bm, Cm)


def test_reduced_mamba2_server_on_card_matches_cpu(dev):
    """The reduced mamba2-130m served on the card (kernels) against the same
    weights served on the CPU (plain versions), prefill and 8 decode steps,
    with the launch counts of the run.  Logits are held at a relative L2
    error <= 3e-2 (TOL_BF16), as tests/test_torch_ssm.py holds them to JAX:
    the scan's fp32 sums are taken in another order on the card, and a value
    rounded to bf16 one ulp apart moves single logits further through four
    random layers."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import Server
    from repro_torch.models import decode_step, init_cache, prefill

    gpu = Server("mamba2-130m", max_len=64, device=dev, seed=3)
    cpu_params = _map(gpu.params, lambda t: t.cpu())
    cfg = gpu.cfg
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)))
    with torch.inference_mode():
        lg, cg = prefill(gpu.params, {"tokens": toks[:, :40].to(dev)}, cfg,
                         init_cache(cfg, 2, 0, dev))
        lc, cc = prefill(cpu_params, {"tokens": toks[:, :40]}, cfg,
                         init_cache(cfg, 2, 0, "cpu"))
        _rel_close(lg, lc, 3e-2)
        for i in range(40, 48):
            lg, cg = decode_step(gpu.params, {"tokens": toks[:, i:i + 1].to(dev)}, cfg, cg, i)
            lc, cc = decode_step(cpu_params, {"tokens": toks[:, i:i + 1]}, cfg, cc, i)
            _rel_close(lg, lc, 3e-2)
    reset_launches()
    out = gpu.generate(toks.numpy()[:, :16], 8)
    assert out["finite"]
    n = cfg.n_layers
    assert {k: v for k, v in launches().items() if v} == {"rmsnorm": (2 * n + 1) * 9,
                                                          "ssd_scan": n}


def _rel_close(got, want, tol):
    torch.cuda.synchronize()
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    rel = float((got - want).norm() / want.norm())
    assert torch.isfinite(got).all() and rel <= tol, f"relative L2 error {rel} > {tol}"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# the SSM train path: the SSD scan's backward, the RMSNorm backward at
# mamba2-130m's widths, a reduced mamba2 train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16384, 768), (16384, 1536)])
def test_rmsnorm_bwd_kernel_at_mamba2_widths_matches_plain(dev, shape):
    """mamba2-130m's train step: the block norm (d 768) and the gated
    out_norm (d_inner 1536) over 8 x 2048 rows."""
    rng = np.random.default_rng(12)
    x, dy = _rand(rng, shape, dev, 3.0), _rand(rng, shape, dev)
    sc = 1.0 + 0.1 * _rand(rng, (shape[1],), dev)
    before = rmsnorm_bwd.launches
    dx, dsc = rmsnorm_bwd(x, sc, dy)
    assert rmsnorm_bwd.launches == before + 1
    rdx, rdsc = rmsnorm_bwd_ref(x, sc, dy)
    _close(dx, rdx, **TOL_BF16)
    _close(dsc, rdsc, rtol=0, atol=2e-2 * float(rdsc.float().abs().max()))


def _ssd_bwd_case(rng, dev, b, s, h, p, n, case):
    x, dt, a_log, Bm, Cm, h0 = _ssd_inputs(rng, dev, b, s, h, p, n, strong="strong" in case,
                                           strided="strided" in case, h0="h0" in case)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32)).to(dev)
    dhf = (torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32)).to(dev)
           if "dhf" in case else None)
    return (x, dt, a_log, Bm, Cm, h0, dy, dhf)


@pytest.mark.parametrize("b,s,h,p,n,case", [
    (2, 256, 4, 16, 16, "plain"),
    (2, 256, 4, 32, 32, "h0_dhf"),
    (1, 512, 3, 64, 128, "plain"),
    (2, 300, 4, 64, 128, "h0_dhf"),          # S = 300: a 44-row tail chunk
    (2, 130, 6, 64, 128, "strided_dhf"),     # the model's slices of one conv output
    (1, 256, 4, 64, 128, "strong_h0_dhf"),   # a_log = log 16, dt up to 3
    (2, 1, 3, 64, 128, "h0_dhf"),            # one row
    (2, 63, 3, 32, 64, "plain"),
    (2, 65, 3, 16, 32, "strong_h0_dhf"),
    (8, 2048, 24, 64, 128, "strided"),       # mamba2-130m's train step
    (2, 2049, 24, 64, 128, "strided_h0_dhf"),  # its tail, from a state
    # the other (P, N) the wrapper takes, with and without h0 and dh_final
    (1, 200, 3, 16, 64, "strided_h0_dhf"),
    (2, 130, 4, 16, 128, "plain"),
    (2, 100, 3, 32, 16, "h0_dhf"),
    (1, 257, 2, 32, 128, "strided"),
    (2, 70, 3, 64, 16, "strided_h0_dhf"),
    (2, 192, 2, 64, 32, "h0"),               # h0 alone
    (2, 129, 3, 64, 64, "dhf"),              # dh_final alone
    (2, 1, 2, 16, 16, "strided_h0_dhf"),     # one row at the smallest P and N
    # many heads: the sum over heads in order and the walkers' chunk loop
    (1, 320, 24, 64, 128, "strided_h0_dhf"),
    (2, 40, 24, 32, 64, "plain"),            # one chunk shorter than 64 rows
    # jamba-1.5-large-398b's P 64, N 16: a tail from a state, strong decay
    (2, 513, 32, 64, 16, "strided_h0_dhf"),
    (2, 130, 8, 64, 16, "strong_h0_dhf"),
])
def test_ssd_scan_bwd_kernel_matches_plain(dev, b, s, h, p, n, case):
    """The plain version at the kernel's 64-row chunks, the comparison
    chip_smoke.py makes (at longer chunks the plain version's own fp32 error
    in ddt, where the exponents' gradients cancel, is larger than the
    kernel's); at mamba2-130m's train shapes also every gradient against fp64
    autograd of the plain scan, by relative L2 <= 1e-3.  The cases cover
    every (P, N) the wrapper takes, S < 64, S = 1 and S not a multiple of
    64, h0 and dh_final both given, both absent or one of them, strided x,
    B and C, and 24 heads over several chunks."""
    rng = np.random.default_rng(13)
    args = _ssd_bwd_case(rng, dev, b, s, h, p, n, case)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*args)
    assert ssd_scan_bwd.launches == before + 1
    want = ssd_scan_bwd_ref(*args, chunk=KERNEL_CHUNK)
    assert (got[5] is None) == (args[5] is None)
    for name, g, w, t in zip(("dx", "ddt", "da_log", "dB", "dC", "dh0"), got, want,
                             (args[0], args[1], args[2], args[3], args[4], args[5])):
        if t is None:
            continue
        assert g.dtype == t.dtype and g.shape == t.shape and g.is_contiguous(), name
        assert torch.isfinite(g.float()).all(), name
        if name == "da_log":
            _close(g, w, rtol=0, atol=3e-2 * float(w.abs().max()))
        else:
            _close(g, w, **TOL_BF16)
    if s >= 2048:
        for name, g, e in zip(("dx", "ddt", "da_log", "dB", "dC", "dh0"), got,
                              _ssd_grads_f64(*args)):
            if g is not None:
                rel = _rel_l2(g, e.to(g.dtype))      # a bf16 output against fp64 in bf16
                assert rel <= 1e-3, f"{name}: relative L2 {rel} against fp64"


def _ssd_grads_f64(x, dt, a_log, Bm, Cm, h0, dy, dhf):
    """The scan's gradients by fp64 autograd of `ssd_scan_ref` at chunk 256
    (dh0 None without h0), as chip_smoke.py's `ssd_grads_f64`."""
    leaves = [t.detach().double().requires_grad_(True) for t in (x, dt, a_log, Bm, Cm)]
    h0l = None if h0 is None else h0.detach().double().requires_grad_(True)
    y, hf = ssd_scan_ref(*leaves, chunk=256, h0=h0l)
    loss = (y * dy.double()).sum()
    if dhf is not None:
        loss = loss + (hf * dhf.double()).sum()
    grads = torch.autograd.grad(loss, leaves + ([h0l] if h0l is not None else []))
    return list(grads) + ([None] if h0l is None else [])


def _rel_l2(got, want) -> float:
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want))


def test_ssd_scan_bwd_kernel_is_bitwise_repeatable(dev):
    """The sums over heads (dB, dC), over batches and chunks (da_log) and
    along each chunk run in a fixed order, with no atomics."""
    rng = np.random.default_rng(14)
    args = _ssd_bwd_case(rng, dev, 8, 2048, 24, 64, 128, "strided_h0_dhf")
    got = ssd_scan_bwd(*args)
    for _ in range(2):
        again = ssd_scan_bwd(*args)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_ssd_scan_bwd_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(15)
    x, dt, a_log, Bm, Cm, h0, dy, dhf = _ssd_bwd_case(rng, dev, 1, 64, 2, 64, 128, "h0_dhf")
    with pytest.raises(ValueError):                 # head dim 48
        ssd_scan_bwd(x[..., :48], dt, a_log, Bm, Cm, None, dy[..., :48].contiguous(), None)
    with pytest.raises(ValueError):                 # d_state 96
        ssd_scan_bwd(x, dt, a_log, Bm[..., :96], Cm[..., :96], None, dy, None)
    with pytest.raises(TypeError):
        ssd_scan_bwd(x.float(), dt, a_log, Bm, Cm, None, dy, None)
    with pytest.raises(TypeError):                  # dy in bf16
        ssd_scan_bwd(x, dt, a_log, Bm, Cm, None, dy.bfloat16(), None)
    with pytest.raises(ValueError):                 # dy not contiguous
        ssd_scan_bwd(x, dt, a_log, Bm, Cm, None, dy.transpose(1, 2).contiguous().transpose(1, 2),
                     None)
    with pytest.raises(ValueError):                 # dh_final of another shape
        ssd_scan_bwd(x, dt, a_log, Bm, Cm, h0, dy, dhf[..., :64])


def test_ssd_scan_op_on_card_runs_both_kernels(dev):
    from repro_torch.kernels import ssd_scan_op
    rng = np.random.default_rng(16)
    x, dt, a_log, Bm, Cm, h0, dy, _ = _ssd_bwd_case(rng, dev, 2, 200, 4, 64, 128, "strided_h0")
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a_log, Bm, Cm, h0)]
    n_f, n_b = ssd_scan.launches, ssd_scan_bwd.launches
    y, _ = ssd_scan_op(*leaves[:5], chunk=256, h0=leaves[5])
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert ssd_scan.launches == n_f + 1 and ssd_scan_bwd.launches == n_b + 1
    want = ssd_scan_bwd_ref(x, dt, a_log, Bm, Cm, h0, dy, None, chunk=256)
    for g, w, t in zip(grads, want, leaves):
        assert g.dtype == t.dtype
        _close(g, w, rtol=3e-2, atol=3e-2 * max(1.0, float(w.float().abs().max())))


def test_reduced_mamba2_train_step_on_card_matches_cpu(dev):
    """One train step of reduced mamba2-130m on the card (kernels) against
    the same weights and batch on the CPU (plain versions): the loss and
    all gradients by relative L2 error <= 3e-2 (the gate of chip_smoke.py's
    train_check_ssm; per leaf a bf16 value one ulp apart moves single
    leaves, tests/test_torch_ssm_train.py), the launch counts of the step,
    and the updated params by relative L2 error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model, loss_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_state, train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-130m").reduced()
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(17), dev)
    rng = np.random.default_rng(18)
    toks = rng.integers(0, cfg.vocab_size, (2, 193))    # three of the kernels' 64-row chunks
    mask = np.ones((2, 192), np.float32)
    mask[1, 40:] = 0
    batches = {d.type: {"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                        "labels": torch.from_numpy(toks[:, 1:]).to(d),
                        "loss_mask": torch.from_numpy(mask).to(d)}
               for d in (dev, torch.device("cpu"))}
    opt_cfg = AdamWConfig(warmup_steps=1)
    states = {"cuda": make_train_state(cfg, opt_cfg, params=params),
              "cpu": make_train_state(cfg, opt_cfg, params=_map(
                  params, lambda t: t.detach().cpu().clone()))}
    grads = {}
    for d, st in states.items():
        loss, _ = loss_fn(st["params"], batches[d], cfg)
        grads[d] = (loss, torch.autograd.grad(loss, tree_leaves(st["params"])))
    _close(grads["cuda"][0], grads["cpu"][0], **TOL_BF16)
    _rel_close(torch.cat([g.float().flatten() for g in grads["cuda"][1]]),
               torch.cat([g.float().flatten() for g in grads["cpu"][1]]), 3e-2)
    reset_launches()
    for d, st in states.items():
        train_step(st, batches[d], cfg, opt_cfg)
    n, c = cfg.n_layers, 8
    assert {k: v for k, v in launches().items() if v} == {
        "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1, "ssd_scan": 2 * n, "ssd_scan_bwd": n,
        "fused_ce": 2 * c, "fused_ce_bwd": c}
    _rel_close(torch.cat([t.float().flatten() for t in tree_leaves(states["cuda"]["params"])]),
               torch.cat([t.float().flatten() for t in tree_leaves(states["cpu"]["params"])]),
               3e-2)


# ---------------------------------------------------------------------------
# the MoE train path: flash at q/k head dim 192 and v head dim 128, the
# RMSNorm backward at kv_norm's row pitch, a reduced deepseek-v2-lite-16b
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s", [512, 200])     # the train shape; a tail of 3 tiles + 8 rows
def test_flash_kernels_at_head_dims_192_128_match_plain(dev, seed, s):
    """MLA's expanded branch (deepseek-v2-lite-16b at full width: 16 heads,
    MHA, q/k [8, 16, S, 192], v [8, 16, S, 128], causal): the forward, dq and
    dk/dv kernels against their plain versions by chip_smoke.py's rule (no
    element past TOL_BF16, lse and delta TOL_LSE), one launch each, outputs
    at their own head dims, and each pass's bits repeated.  Two seeds."""
    cs = _chip_smoke()
    randn = cs.bf16_normal(np.random.default_rng(100 + seed), dev)
    args = cs.mla_flash_inputs(randn, 8, s)
    before = [w.launches for w in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    rec = cs.mla_flash_check(*args)
    # the check launches each pass three times: once checked, twice repeated
    assert [w.launches for w in (flash_attention_fwd, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == [n + 3 for n in before]
    assert rec["shapes_ok"], rec
    assert all(e <= 0 for e in rec["excess"].values()), rec
    assert all(rec["bitwise_repeatable"].values()), rec


def test_flash_wrappers_refuse_an_unlisted_head_dim_pair(dev):
    """q/k and v head dims may differ only as HEAD_DIM_PAIRS lists them."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIM_PAIRS
    assert (192, 128) in HEAD_DIM_PAIRS and (128, 192) not in HEAD_DIM_PAIRS
    q = torch.zeros(1, 64, 2, 128, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    v = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, v)


@pytest.mark.parametrize("seed", [0, 1])
def test_rmsnorm_bwd_kernel_reads_x_at_kv_norms_pitch(dev, seed):
    """kv_norm's backward: x the first 512 columns of [2, 96, 576] rows, read
    in place at pitch 576 as the forward read it; dy contiguous; dx written
    contiguous; one launch; dscale's bits repeated."""
    rng = np.random.default_rng(30 + seed)
    full = _rand(rng, (2, 96, 576), dev, 3.0)
    x = full[..., :512]
    sc = 1.0 + 0.1 * _rand(rng, (512,), dev)
    dy = _rand(rng, (2, 96, 512), dev)
    before = rmsnorm_bwd.launches
    dx, ds = rmsnorm_bwd(x, sc, dy)
    assert rmsnorm_bwd.launches == before + 1
    assert dx.is_contiguous() and dx.shape == x.shape
    rx, rs = rmsnorm_bwd_ref(x, sc, dy)
    _close(dx, rx, **TOL_BF16)
    _close(ds, rs, rtol=0, atol=2e-2 * float(rs.float().abs().max()))
    dx2, ds2 = rmsnorm_bwd(x, sc, dy)
    assert torch.equal(dx2, dx) and torch.equal(ds2, ds)


def test_rmsnorm_op_backward_on_card_reads_the_saved_slice(dev):
    """The autograd op saves kv_norm's slice as it is: its backward launches
    the kernel on the pitched rows, and the gradient reaches the wide
    projection through the slice."""
    from repro_torch.kernels import rmsnorm_op, rmsnorm_ref
    rng = np.random.default_rng(32)
    full = _rand(rng, (2, 64, 576), dev, 3.0).requires_grad_(True)
    sc = (1.0 + 0.1 * _rand(rng, (512,), dev)).requires_grad_(True)
    dy = _rand(rng, (2, 64, 512), dev)
    before = rmsnorm_bwd.launches
    g_full, g_sc = torch.autograd.grad(rmsnorm_op(full[..., :512], sc), (full, sc), dy)
    assert rmsnorm_bwd.launches == before + 1
    w_full, w_sc = torch.autograd.grad(rmsnorm_ref(full[..., :512], sc), (full, sc), dy)
    _close(g_full, w_full, **TOL_BF16)
    assert not g_full[..., 512:].any()
    _close(g_sc, w_sc, rtol=0, atol=2e-2 * float(w_sc.float().abs().max()))


@pytest.mark.parametrize("seed", [40, 41])
def test_reduced_deepseek_train_step_on_card_matches_cpu(dev, seed):
    """Reduced deepseek-v2-lite-16b with MLA at the full model's head dims
    (so its attention runs the <192, 128> flash kernels), batch 2 x 192
    tokens: the loss and every gradient on the card against the CPU with
    the CPU's routing pinned to the card's, by chip_smoke.py's
    train_check_moe (relative error of the loss and relative L2 error of all
    gradients <= 3e-2; no routing flip at a top-k gap >= 1e-2); then the
    launch counts of one train step on the card."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_state, train_step

    cs = _chip_smoke()
    cfg = cs.moe_small_config()
    seq = 3 * cs.FLASH_TILE
    rec = cs.train_check(dev, cfg, seed, seq, row1_len=seq - 40)
    assert rec["moe_route_calls"] == 2 * (cfg.n_layers - cfg.moe.n_dense_prefix)
    assert rec["ok"], {k: v for k, v in rec.items() if k != "flips"}
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 193)))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    opt_cfg = AdamWConfig(warmup_steps=1)
    state = make_train_state(cfg, opt_cfg, params=params)
    reset_launches()
    train_step(state, batch, cfg, opt_cfg)
    n, c = cfg.n_layers, 8
    assert {k: v for k, v in launches().items() if v} == {
        "rmsnorm": 6 * n + 1, "rmsnorm_bwd": 3 * n + 1, "flash_attention_fwd": 2 * n,
        "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n, "fused_ce": 2 * c,
        "fused_ce_bwd": c}


# ---------------------------------------------------------------------------
# deepseek-v3-671b's serve and train paths: the RMSNorm at d 7168 and q_norm's
# 1536, the CE at vocab 129280 (the MTP loss's 584-row chunk too), the flash
# passes at <192, 128> over 128 heads, a reduced train step; each held by
# chip_smoke.py's own rule at two seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rows,d", [(2048, 7168), (2048, 1536), (4, 7168), (4, 1536)])
def test_rmsnorm_kernel_at_deepseek_v3_widths_matches_plain(dev, seed, rows, d):
    """serve_v3's norms: attn_norm and ffn_norm at d 7168, q_norm at 1536,
    at the prefill's 2048 rows and a decode step's 4 (one row over 448
    threads of two vectors each at d 7168), by chip_smoke.rmsnorm_check."""
    cs = _chip_smoke()
    randn = cs.bf16_normal(np.random.default_rng(200 + seed), dev)
    x, sc = randn(rows, d, scale=3.0), 1.0 + 0.1 * randn(d)
    before = rmsnorm.launches
    rec = cs.rmsnorm_check(x, sc)
    assert rmsnorm.launches == before + 1
    assert rec["excess"] <= 0, rec


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d", [7168, 1536])
def test_rmsnorm_bwd_kernel_at_deepseek_v3_widths_matches_plain(dev, seed, d):
    """train_v3's norm backward over 8 x 512 rows: d 7168 (a 512-thread group
    a row, some threads holding one vector and some two) and q_norm's 1536,
    by chip_smoke.rmsnorm_bwd_check: within tolerance, bits repeated."""
    cs = _chip_smoke()
    randn = cs.bf16_normal(np.random.default_rng(210 + seed), dev)
    x, sc = randn(4096, d, scale=3.0), 1.0 + 0.1 * randn(d)
    dy = randn(4096, d)
    before = rmsnorm_bwd.launches
    rec = cs.rmsnorm_bwd_check(x, sc, dy)
    assert rmsnorm_bwd.launches == before + 3       # checked, then twice repeated
    assert rec["excess"] <= 0 and rec["bitwise_repeatable"], rec


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rows", [512, 584])
def test_fused_ce_kernels_at_deepseek_v3_vocab_match_plain(dev, seed, rows):
    """train_v3's CE chunks at vocab 129280 (126.25 blocks of 1024 columns):
    one of the main loss's 8 ([512, 129280]) and one of the MTP loss's 7
    ([8 x 73 = 584, 129280]), forward and backward by chip_smoke.ce_check."""
    cs = _chip_smoke()
    args = cs.ce_inputs(np.random.default_rng(220 + seed), dev, rows, 129280)
    n_f, n_b = fused_ce.launches, fused_ce_bwd.launches
    rec = cs.ce_check(*args)
    assert fused_ce.launches == n_f + 1 and fused_ce_bwd.launches == n_b + 1
    assert all(e <= 0 for e in rec["excess"].values()), rec


@pytest.mark.parametrize("seed", [0, 1])
def test_flash_kernels_at_head_dims_192_128_over_128_heads_match_plain(dev, seed):
    """MLA's expanded branch at deepseek-v3-671b's width: 128 heads, MHA,
    q/k [8, 128, 512, 192], v [8, 128, 512, 128], causal (a grid 8x
    deepseek-v2-lite-16b's), by chip_smoke.mla_flash_check."""
    cs = _chip_smoke()
    randn = cs.bf16_normal(np.random.default_rng(230 + seed), dev)
    rec = cs.mla_flash_check(*cs.mla_flash_inputs(randn, 8, 512, cs.V3_HEADS))
    assert rec["shapes_ok"], rec
    assert all(e <= 0 for e in rec["excess"].values()), rec
    assert all(rec["bitwise_repeatable"].values()), rec


@pytest.mark.parametrize("seed", [42, 43])
def test_reduced_deepseek_v3_train_step_on_card_matches_cpu(dev, seed):
    """Reduced deepseek-v3-671b (3 dense layers, 1 MoE layer with the sigmoid
    router and a router_bias from the seed, the MTP layer; MLA at the full
    head dims, q-LoRA at 1536), batch 2 x 192 tokens: the loss and every
    gradient on the card against the CPU, the CPU's routing pinned to the
    card's, by chip_smoke.py's train_check_v3 (router_bias's gradient
    exactly zero on both sides); then the launch counts of one train step
    on the card against chip_smoke.moe_train_launches."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_state, train_step

    cs = _chip_smoke()
    cfg = cs.v3_small_config()
    seq = 3 * cs.FLASH_TILE
    rec = cs.train_check(dev, cfg, seed, seq, row1_len=seq - 40)
    assert rec["moe_route_calls"] == 2 * (cfg.n_layers - cfg.moe.n_dense_prefix)
    assert list(rec["zero_grad_leaves_max_abs"]) == ["blocks.0.ffn.router_bias"]
    assert rec["ok"], {k: v for k, v in rec.items() if k != "flips"}
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 193)))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    opt_cfg = AdamWConfig(warmup_steps=1)
    state = make_train_state(cfg, opt_cfg, params=params)
    reset_launches()
    _, metrics = train_step(state, batch, cfg, opt_cfg)
    assert torch.isfinite(metrics["mtp_ce"])
    assert {k: v for k, v in launches().items() if v} == cs.moe_train_launches(cfg, seq)


# ---------------------------------------------------------------------------
# jamba-1.5-large-398b's shapes: the SSD scan at N 16 over 256 heads and its
# backward at P 64, N 16 at a full-width train step's shape, by chip_smoke.py's
# rules; a reduced hybrid train step card vs CPU (rep 8, P 64, N 16)
# ---------------------------------------------------------------------------

def test_ssd_scan_kernel_at_jamba_shape_matches_fp64(dev):
    """The serve prefill's scan, x [4, 512, 256, 64] at N 16 from zeros and a
    513-row tail from a nonzero state: y and the final state against
    chip_smoke.py's fp64 recurrence by relative L2 <= TOL_SSD_REL_L2, and
    bitwise repeatable."""
    cs = _chip_smoke()
    rng = np.random.default_rng(20)
    randn = cs.bf16_normal(rng, dev)
    for s, h0_scale in ((512, 0.0), (513, 0.3)):
        args, h0 = cs.ssd_inputs(randn, rng, dev, 4, s, 256, 64, 16, h0_scale)
        with torch.inference_mode():
            y, hf = ssd_scan(*args, h0=h0)
            rel = cs.ssd_rel_errors(args, h0, {"kernel": (y, hf)})["kernel"]
            assert max(rel.values()) <= cs.TOL_SSD_REL_L2, rel
            y2, hf2 = ssd_scan(*args, h0=h0)
            assert torch.equal(y2, y) and torch.equal(hf2, hf)


def test_ssd_scan_bwd_kernel_at_jamba_train_shape_matches_plain_and_fp64(dev):
    """A full-width jamba train step's scan gradient, [8, 512, 256, 64] at
    P 64, N 16 from no state: every gradient against the plain version at
    the kernel's chunk and against fp64 autograd by relative L2 <= 1e-3 (a
    bf16 output against the fp64 gradient rounded to bf16), bitwise
    repeatable."""
    rng = np.random.default_rng(21)
    args = _ssd_bwd_case(rng, dev, 8, 512, 256, 64, 16, "strided")
    got = ssd_scan_bwd(*args)
    want = ssd_scan_bwd_ref(*args, chunk=KERNEL_CHUNK)
    names = ("dx", "ddt", "da_log", "dB", "dC")
    for name, g, w in zip(names, got, want):
        if name == "da_log":
            _close(g, w, rtol=0, atol=3e-2 * float(w.abs().max()))
        else:
            _close(g, w, **TOL_BF16)
    for name, g, e in zip(names, got, _ssd_grads_f64(*args)):
        rel = _rel_l2(g, e.to(g.dtype))
        assert rel <= 1e-3, f"{name}: relative L2 {rel} against fp64"
    again = ssd_scan_bwd(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got) if g is not None)


@pytest.mark.parametrize("seed", [44, 45])
def test_reduced_hybrid_train_step_on_card_matches_cpu(dev, seed):
    """Reduced jamba-1.5-large-398b (one period block; 8 query heads over 1 kv
    head at D 128, rep 8; the SSD kernels at P 64, N 16), batch 2 x 192
    tokens: the loss and every gradient on the card against the CPU unit by
    unit, the CPU's routing pinned to the card's, by chip_smoke.py's
    train_check_hybrid (`hybrid_train_check`); then the launch counts of one
    train step on the card against chip_smoke.hybrid_train_launches."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import make_train_state, train_step

    cs = _chip_smoke()
    cfg = cs.hybrid_small_config()
    seq = 3 * cs.SSD_CHUNK
    rec = cs.hybrid_train_check(dev, cfg, seed, seq, row1_len=seq - 40)
    assert rec["moe_route_calls"] == cs.moe_layer_count(cfg) == 4
    assert rec["ok"], {k: v for k, v in rec.items() if k != "flips"}
    with torch.no_grad():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 193)))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    opt_cfg = AdamWConfig(warmup_steps=1)
    state = make_train_state(cfg, opt_cfg, params=params)
    reset_launches()
    _, metrics = train_step(state, batch, cfg, opt_cfg)
    assert torch.isfinite(metrics["loss"]) and float(metrics["aux"]) > 0
    assert {k: v for k, v in launches().items() if v} == cs.hybrid_train_launches(cfg)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
On the card they run with `python -m pytest -q -m cuda tests/test_torch_cuda.py`
(this file imports no JAX).  Each kernel is compared with its plain version
on the same bf16 inputs at TOL_BF16 (1e-2 for rmsnorm and lse), and each
wrapper's launch counter must rise.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, decode_attention_ref,
                                 flash_attention_fwd, rmsnorm, rmsnorm_ref)
from repro_torch.kernels.flash_attention import attention_with_lse_ref

TOL_BF16 = dict(rtol=3e-2, atol=3e-2)

pytestmark = pytest.mark.cuda


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
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("shape", [(8, 128), (4, 32, 128), (3, 4096), (2048, 4096)])
def test_rmsnorm_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, dev, 3.0)
    sc = 1.0 + 0.1 * _rand(rng, (shape[-1],), dev)
    before = rmsnorm.launches
    out = rmsnorm(x, sc)
    assert rmsnorm.launches == before + 1
    _close(out, rmsnorm_ref(x, sc), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,h,hkv,s,t,d,q_offset,kv_len,causal", [
    (2, 4, 2, 128, 128, 64, 0, 128, True),     # GQA, whole tiles
    (1, 8, 1, 100, 100, 128, 0, 100, True),    # MQA, S not a multiple of 64
    (2, 32, 2, 130, 300, 128, 40, 170, True),  # chunked prefill into a longer cache
    (1, 2, 2, 64, 64, 32, 0, 64, False),       # full attention
    (4, 32, 2, 512, 1024, 128, 0, 512, True),  # serve-path prefill shape
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


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 128, device=dev)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(128, device=dev))
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
    assert launches() == {"rmsnorm": (2 * n + 1) * 9, "flash_attention_fwd": n,
                          "decode_attention": n * 8}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)

"""The kernels' limits on the CPU: the RMSNorm backward's plain version at the
widest row a config gives it (jamba-1.5-large-398b's gated out_norm over
d_inner 16384) against `jax.grad` of the JAX package's `rmsnorm_ref`, and
every wrapper's abstract path (a fake tensor, as the dry run traces) refusing
what the kernel refuses, before it records any work.

Tolerances are tests/test_torch_kernels.py's for the backward: TOL for fp32,
TOL_BF16 for bf16, dscale's atol scaled by its largest |value| (a sum over
the rows)."""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.convert import to_tensor
from repro_torch.kernels import abstract, rmsnorm_bwd_ref
from repro_torch.kernels.cross_entropy import kernel as ce_kernel
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 8192, 16384])
def test_rmsnorm_bwd_ref_matches_jax_grad_at_width(d, dt):
    """rmsnorm_bwd_ref at d 16384, the wrapper's widest row (MAX_BWD_D), and
    at d 8192 (the widest before) and 8 as controls, against jax.grad of
    JAX's rmsnorm_ref on the same inputs."""
    assert rms_kernel.MAX_BWD_D == 16384
    rng = np.random.default_rng(d)
    shape = (4, d)
    x = (rng.standard_normal(shape, dtype=np.float32) * 3.0).astype(DTYPES[dt])
    sc = (1.0 + 0.1 * rng.standard_normal(d)).astype(DTYPES[dt])
    dy = rng.standard_normal(shape, dtype=np.float32).astype(DTYPES[dt])
    jdx, jds = jax.grad(lambda a, b: jnp.sum(jax_rmsnorm_ref(a, b).astype(jnp.float32)
                                             * jnp.asarray(dy, jnp.float32)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sc))
    dx, ds = rmsnorm_bwd_ref(to_tensor(x), to_tensor(sc), to_tensor(dy))
    tol = TOL if dt == "f32" else TOL_BF16
    np.testing.assert_allclose(_np(dx), _np(jdx), **tol)
    np.testing.assert_allclose(_np(ds), _np(jds), rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, float(np.abs(_np(jds)).max())))


def _fake(mode, shape, dtype=torch.bfloat16):
    return mode.from_tensor(torch.zeros(shape, dtype=dtype))


def _rms_bwd(m, d=16392, **kw):
    x = _fake(m, (4, d))
    return rms_kernel.rmsnorm_bwd, (x, _fake(m, (d,)), _fake(m, (4, d))), kw


def _flash(m, name, d=128, dv=128, lse_rows=16, **kw):
    q, k, v = _fake(m, (1, 4, 16, d)), _fake(m, (1, 2, 16, d)), _fake(m, (1, 2, 16, dv))
    rows = _fake(m, (1, 4, lse_rows), torch.float32)
    if name == "fwd":
        return flash_kernel.flash_attention_fwd, (q, k, v), kw
    if name == "dq":
        return flash_kernel.flash_attention_bwd_dq, (q, k, v, _fake(m, (1, 4, 16, dv)),
                                                     _fake(m, (1, 4, 16, dv)), rows), kw
    return flash_kernel.flash_attention_bwd_dkv, (q, k, v, _fake(m, (1, 4, 16, dv)), rows,
                                                  rows), kw


def _decode(m, d=32, lengths=torch.int32, **kw):
    return decode_kernel.decode_attention, (
        _fake(m, (1, 4, d)), _fake(m, (1, 20, 2, d)), _fake(m, (1, 20, 2, d)),
        _fake(m, (1,), lengths)), kw


def _ce(m, name, rows=4, logits=torch.bfloat16):
    args = (_fake(m, (4, 64), logits), _fake(m, (rows,), torch.int64),
            _fake(m, (4,), torch.float32))
    if name == "fwd":
        return ce_kernel.fused_ce, args, {}
    return ce_kernel.fused_ce_bwd, args + (_fake(m, (4,), torch.float32),
                                           _fake(m, (4,), torch.float32)), {}


def _ssd(m, name, p=16, n=16, dy_seq=8):
    f32 = torch.float32
    args = (_fake(m, (1, 8, 2, p)), _fake(m, (1, 8, 2), f32), _fake(m, (2,), f32),
            _fake(m, (1, 8, n)), _fake(m, (1, 8, n)))
    if name == "fwd":
        return ssd_kernel.ssd_scan, args, {}
    return ssd_kernel.ssd_scan_bwd, args + (None, _fake(m, (1, dy_seq, 2, p), f32), None), {}


# a call the kernel (its wrapper's checks or its C entry point) refuses, for
# every wrapper
REFUSED = {
    "rmsnorm past MAX_D": lambda m: (rms_kernel.rmsnorm, (_fake(m, (4, 32776)),
                                                          _fake(m, (32776,))), {}),
    "rmsnorm at D % 8": lambda m: (rms_kernel.rmsnorm, (_fake(m, (4, 12)), _fake(m, (12,))), {}),
    "rmsnorm fp32 x": lambda m: (rms_kernel.rmsnorm, (_fake(m, (4, 64), torch.float32),
                                                      _fake(m, (64,))), {}),
    "rmsnorm_bwd past MAX_BWD_D": lambda m: _rms_bwd(m),
    "rmsnorm_bwd dy transposed": lambda m: (rms_kernel.rmsnorm_bwd, (
        _fake(m, (64, 64)), _fake(m, (64,)), _fake(m, (64, 64)).t()), {}),
    "flash fwd at head dim 48": lambda m: _flash(m, "fwd", d=48, dv=48),
    "flash fwd kv_len past T": lambda m: _flash(m, "fwd", kv_len=17),
    "flash dq lse rows": lambda m: _flash(m, "dq", lse_rows=15),
    "flash dkv cluster 3": lambda m: _flash(m, "dkv", cluster=3),
    "decode at head dim 48": lambda m: _decode(m, d=48),
    "decode int64 lengths": lambda m: _decode(m, lengths=torch.int64),
    "decode cluster 3": lambda m: _decode(m, cluster=3),
    "ce labels rows": lambda m: _ce(m, "fwd", rows=3),
    "ce fp32 logits": lambda m: _ce(m, "fwd", logits=torch.float32),
    "ce_bwd labels rows": lambda m: _ce(m, "bwd", rows=3),
    "ssd_scan at P 128": lambda m: _ssd(m, "fwd", p=128),
    "ssd_scan at N 8": lambda m: _ssd(m, "fwd", n=8),
    "ssd_scan_bwd dy rows": lambda m: _ssd(m, "bwd", dy_seq=7),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_fake_call_refuses_what_the_kernel_refuses_and_records_nothing(case):
    """A fake tensor meets the checks a CUDA tensor meets: a shape, dtype or
    layout the kernel refuses raises on the abstract path too, before
    `.traced` counts the call or a recorder sees any work."""
    work = []
    with FakeTensorMode() as mode, abstract.recording(lambda *w: work.append(w)):
        wrapper, args, kw = REFUSED[case](mode)
        traced, launches = wrapper.traced, wrapper.launches
        with pytest.raises((ValueError, TypeError)):
            wrapper(*args, **kw)
    assert wrapper.traced == traced and wrapper.launches == launches and work == []


def test_fake_rmsnorm_bwd_at_max_bwd_d_is_traced():
    """At d 16384 (jamba's gated out_norm) the abstract path records one
    call and its bytes: x and dy read and dx written once, dscale's rows."""
    work = []
    with FakeTensorMode() as mode, abstract.recording(lambda *w: work.append(w)):
        wrapper, args, _ = _rms_bwd(mode, d=16384)
        traced = wrapper.traced
        dx, ds = wrapper(*args)
    assert wrapper.traced == traced + 1 and dx.shape == (4, 16384) and ds.shape == (16384,)
    assert work == [("rmsnorm_bwd", 10 * 4 * 16384, 3 * 4 * 16384 * 2 + 2 * 16384 * 2)]

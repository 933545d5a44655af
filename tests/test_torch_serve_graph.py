"""The compiled decode step on the CPU: the position as a device scalar.

JAX's Server jits `serve_step` once for a batch shape, the position a
traced `jnp.int32` and the cache donated.  The port's counterpart is a CUDA
graph of the decode step, captured once per batch size and replayed for
every token (`launch/serve.py`).  A graph replays fixed shapes and reads
nothing back to the host, so the step may not read its position on the
host nor copy host data to the card.  The CPU cannot capture a graph; these
tests hold what a capture needs, on six reduced configs at the sizes of
tests/test_torch_serve.py (chatglm3-6b, stablelm-3b, mamba2-130m,
deepseek-v2-lite-16b, musicgen-large with its sinusoidal positions and
stub frontend, and chip_smoke.py's `hybrid_small_config`):

* `serve_step` traced on fake tensors on device "cuda" at a fake 0-d
  position (which has no value to read) finishes, and records no host read
  (`_local_scalar_dense`), no op whose output size depends on data
  (`nonzero`, `masked_select`), no tensor made from host data
  (`lift_fresh`) and no op that takes a CPU tensor into a "cuda" one;
* `serve_step` at a 0-d tensor position gives the bits of `serve_step` at
  the int position, and both are within test_torch_serve.py's bf16
  tolerance, 3e-2, of JAX's `serve_step(..., jnp.int32(pos), cfg)`, over a
  prefill and three decode steps: max |diff| over max |logit| (chip_smoke.py's
  cross-check gate) and the relative L2 error (tests/test_torch_ssm.py's),
  each <= 3e-2.  Elementwise at rtol = atol = 3e-2 a few of 1024 logits near
  0 fall outside for stablelm-3b (head dim 32), mamba2-130m and the hybrid,
  as tests/test_torch_families.py records for pixtral-12b; measured, max
  |diff| / max |logit| <= 1.4e-2 and relative L2 <= 1.2e-2 on all six.
  Each MoE layer's selection is pinned to JAX's, read by
  tests/test_torch_hybrid.py's `top_k` spy;
* a Server run on prompts A, then B, then A again gives the first run's
  tokens and logits bitwise: it keeps one cache per batch size and zeroes
  it at each call (the Mamba layers' states are the prefill's h0).
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_host_traffic import HostTraffic

from repro.configs import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import prefill as jax_prefill
from repro.runtime.steps import serve_step as jax_serve_step
from repro_torch.configs import InputShape, get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import add_launches, launches, reset_launches
from repro_torch.launch.serve import Server
from repro_torch.models import init_cache
from repro_torch.runtime.steps import (abstract_batch, abstract_cache, abstract_params,
                                       prefill_step, serve_step)
from repro_torch.tree import tree_leaves, tree_map

B, S, MAX_LEN = 2, 16, 32
STEPS = 3
TOL_BF16 = 3e-2
STRICT_BF16 = {"xla_allow_excess_precision": False}
HYBRID = "jamba-1.5-large-398b"
CONFIGS = ["chatglm3-6b", "stablelm-3b", "mamba2-130m", "deepseek-v2-lite-16b",
           "musicgen-large", "hybrid_small"]


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HY = _module("test_torch_hybrid")      # `_jax_routed`, `_port_pinned`: JAX's routes pinned


def _configs(name):
    """(JAX config, port config) of one of CONFIGS, reduced."""
    if name == "hybrid_small":           # chip_smoke.py's hybrid_small_config, both sides
        cfg = HY.CS.hybrid_small_config()
        jfull = jax_get_config(HYBRID)
        jcfg = jfull.reduced(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                             d_head=cfg.head_dim, ssm=jfull.ssm)
        return jcfg, cfg
    return jax_get_config(name).reduced(), get_config(name).reduced()


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_at_a_position_with_no_value_reads_nothing_on_the_host(name):
    """The step on tensors with no values on a device other than the host
    ("meta": a CPU build of torch cannot take a fake "cuda" tensor's views;
    tests/test_torch_cuda.py traces the dry run's fake "cuda" tensors on
    the card), the position a 0-d int64 of no value: the step finishes with
    no host read and no host-to-device copy, the cache keeps its shapes."""
    _, cfg = _configs(name)
    params = tree_map(_meta, abstract_params(cfg, "cpu"))
    cache = init_cache(cfg, B, MAX_LEN, "meta")
    batch = tree_map(_meta, abstract_batch(cfg, InputShape("decode", MAX_LEN, B, "decode"),
                                           for_decode=True, device="cpu"))
    shapes = [tuple(t.shape) for t in tree_leaves(cache)]
    pos = torch.empty((), dtype=torch.long, device="meta")
    log = HostTraffic()
    with log, torch.inference_mode():
        logits, new_cache = serve_step(params, cache, batch, pos, cfg)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size) and logits.is_meta
    assert [tuple(t.shape) for t in tree_leaves(new_cache)] == shapes
    assert not log.host_ops(), log.host_ops()
    assert not log.to_device, log.to_device
    # the position is used: the decode step's cache write is an index copy
    # (the ssm family has no positions: its states are copied in place)
    assert ("index_copy_" in log.names) == (cfg.family != "ssm")


def test_host_traffic_sees_a_host_read_and_a_host_to_device_copy():
    """The recorder of the test above is not blind: `.item()` and `int(t)`
    of a position with no value fail and are recorded, and host data taken
    to the device is recorded."""
    pos = torch.empty((), dtype=torch.long, device="meta")
    log = HostTraffic()
    with log:
        with pytest.raises(Exception):
            pos.item()
        with pytest.raises(Exception):
            int(pos)
        torch.zeros(3).to("meta")
        torch.ones(2, device="meta") * torch.tensor([2.0]).to("meta")
    assert {"_local_scalar_dense", "lift_fresh"} <= set(log.host_ops())
    assert log.to_device == ["_to_copy", "_to_copy"]


def _models(name):
    jcfg, cfg = _configs(name)
    jp, _ = jax_init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg)


def _batches(cfg, rng, n):
    """n positions' numpy batches [B, n]: tokens, and a stub frontend's
    embeds (bf16 on both sides)."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.frontend is not None:
        out["embeds"] = (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _at(batch, lo, hi, side):
    if side == "jax":
        return {k: jnp.asarray(v[:, lo:hi], jnp.bfloat16 if k == "embeds" else jnp.int32)
                for k, v in batch.items()}
    return {k: (torch.from_numpy(v[:, lo:hi]).to(torch.bfloat16) if k == "embeds"
                else torch.from_numpy(v[:, lo:hi]).long()) for k, v in batch.items()}


def _jax_serve(params, batch, cfg, cache, pos):
    return jax_serve_step(params, cache, batch, pos, cfg)


def _jax_run(fn, jcfg, *args):
    """A JAX step, jitted strict, with its MoE selections (None without MoE)."""
    if jcfg.moe is not None:
        return HY._jax_routed(fn, *args)
    return jax.jit(fn, static_argnums=(2,), compiler_options=STRICT_BF16)(*args), None


def _port_run(fn, routes, *args):
    if routes is not None:
        return HY._port_pinned(fn, routes, *args)
    with torch.inference_mode():
        return fn(*args)


def _close(got, want, what):
    """The bf16 bound of the module docstring: max |diff| and the relative
    L2 error, each within TOL_BF16 of the logits' scale."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    worst = float(np.abs(got - want).max() / np.abs(want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert worst <= TOL_BF16 and rel <= TOL_BF16, f"{what}: max |diff| / max |logit| {worst}, " \
        f"relative L2 {rel}"


@pytest.mark.parametrize("name", CONFIGS)
def test_tensor_position_decode_is_the_int_one_bitwise_and_jaxs(name):
    """A prefill of [2, 16], then three decode steps fed the same tokens (and
    embeds): the port at the int position and at a 0-d int64 tensor
    position, each from its own cache, give equal bits (logits and cache);
    both within the bf16 tolerance of JAX's serve_step at jnp.int32."""
    jcfg, cfg, jp, tp = _models(name)
    batch = _batches(cfg, np.random.default_rng(6), S + STEPS)
    (jl, jc), routes = _jax_run(jax_prefill, jcfg, jp, _at(batch, 0, S, "jax"), jcfg,
                                jax_init_cache(jcfg, B, MAX_LEN))
    caches = {}
    for kind in ("int", "tensor"):
        tl, caches[kind] = _port_run(lambda p, b, c, cache: prefill_step(p, cache, b, c),
                                     routes, tp, _at(batch, 0, S, "torch"), cfg,
                                     init_cache(cfg, B, MAX_LEN, "cpu"))
    _close(tl, jl, "prefill")
    for i in range(STEPS):
        pos = S + i
        (jl, jc), routes = _jax_run(_jax_serve, jcfg, jp, _at(batch, pos, pos + 1, "jax"),
                                    jcfg, jc, jnp.int32(pos))
        out = {}
        for kind, p in (("int", pos), ("tensor", torch.tensor(pos))):
            out[kind], caches[kind] = _port_run(
                lambda pr, b, c, cache, at: serve_step(pr, cache, b, at, c), routes, tp,
                _at(batch, pos, pos + 1, "torch"), cfg, caches[kind], p)
        assert torch.equal(out["int"], out["tensor"]), f"step {i}"
        for a, b in zip(tree_leaves(caches["int"]), tree_leaves(caches["tensor"])):
            assert torch.equal(a, b), f"step {i}: cache"
        _close(out["tensor"], jl, f"step {i}")


@pytest.mark.parametrize("arch", ["mamba2-130m", HYBRID])
def test_server_repeats_a_call_bitwise_after_another(arch):
    """One Server, prompts A, then B, then A: the third call's tokens and
    last logits are the first's, bit for bit (the kept cache is zeroed, the
    Mamba states included); the batch size's cache is the same tensors at
    every call; on the CPU nothing is captured (capture_s 0) and the launch
    counters stay 0 (plain versions)."""
    srv = Server(arch, max_len=MAX_LEN, device="cpu", seed=1)
    rng = np.random.default_rng(12)
    a, b = (rng.integers(1, srv.cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(2))
    reset_launches()
    first = srv.generate(a, 4)
    cache = [t.data_ptr() for t in tree_leaves(srv._decodes[B].cache)]
    other = srv.generate(b, 4)
    again = srv.generate(a, 4)
    assert [t.data_ptr() for t in tree_leaves(srv._decodes[B].cache)] == cache
    assert not np.array_equal(first["tokens"], other["tokens"])
    np.testing.assert_array_equal(again["tokens"], first["tokens"])
    assert torch.equal(again["last_logits"], first["last_logits"])
    assert first["finite"] and again["finite"]
    assert first["capture_s"] == again["capture_s"] == 0.0
    assert srv.decode_graph(B) is None
    assert not any(launches().values())


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-v2-lite-16b"])
def test_server_decode_is_the_eager_step_loop(arch):
    """Server.generate against chip_smoke.py's `eager_generate` (a loop of
    prefill_step + serve_step at int positions on the same weights): equal
    tokens and bitwise last logits (the Server's step writes the token, the
    finite flag and the position in place); `last_logits` is a copy, not
    the step's buffer."""
    srv = Server(arch, max_len=MAX_LEN, device="cpu", seed=2)
    prompts = np.random.default_rng(13).integers(1, srv.cfg.vocab_size, (B, S)).astype(np.int32)
    out = srv.generate(prompts, 5)
    ref = HY.CS.eager_generate(srv, prompts, 5)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert torch.equal(out["last_logits"], ref["last_logits"])
    with torch.inference_mode():
        out["last_logits"].zero_()
    assert torch.equal(srv.generate(prompts, 5)["last_logits"], ref["last_logits"])


def test_add_launches_takes_counts_out_and_back():
    """A capture's counts taken back out (times -1), one step's added at each
    replay: `launches()` then counts kernels run."""
    reset_launches()
    step = {"rmsnorm": 9, "decode_attention": 4}
    add_launches(step)
    add_launches(step, -1)
    assert not any(launches().values())
    for _ in range(3):
        add_launches(step)
    got = launches()
    assert got["rmsnorm"] == 27 and got["decode_attention"] == 12
    assert sum(got.values()) == 39
    reset_launches()


# three nodes and an edge of a decode graph's DOT dump (CUDA 12.8's
# `cudaGraphDebugDotPrint`, as `CUDAGraph.debug_dump` writes it on the card)
_DOT = r'''digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_4"[style="bold" shape="record" label="{KERNEL
| {ID | 4 (topoId: 287) | _ZN43_GLOBAL__N__74c2a8ec_10_rmsnorm_cu_09bc4b2c14rmsnorm_kernelILi1EEEvPK13__nv_bfloat16S3_PS1_iiiif\<\<\<2,32,0\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_5"[style="bold" shape="record" label="{KERNEL
| {ID | 5 (topoId: 286) | nvjet_tst_64x8_64x16_2x1_v_bz_NNT\<\<\<2,384,164308\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_6"[style="bold" shape="record" label="{KERNEL
| {ID | 6 (topoId: 285) | _ZN52_GLOBAL__N__1f2e3d4c_19_decode_attention_cu_5a6b7c8d13decode_kernelILi128ELi1EEEvNS_6ParamsE\<\<\<8,128,93184\>\>\>}
}"];

"graph_1_node_7"[style="bold" shape="record" label="{
MEMCPY
| {{ID | node handle} | {290 (topoId: 1) | 0x000000001A1F5C90}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];

"graph_1_node_8"[style="bold" shape="record" label="{
MEMSET
| {{ID | node handle} | {291 (topoId: 0) | 0x000000001A1F6C90}}
}"];

"graph_1_node_4" -> "graph_1_node_5" [headlabel=0];
"graph_1_node_5" -> "graph_1_node_6" [headlabel=0];
}
}
'''


def test_graph_kernel_nodes_reads_a_decode_graphs_dump():
    """chip_smoke.py's reading of a graph's DOT dump: kernel nodes by symbol,
    the hand-written ones by wrapper (the RMSNorm forward's symbol apart
    from its backward's), copies by kind, other nodes by type, edges not
    counted as nodes."""
    got = HY.CS.graph_kernel_nodes(_DOT)
    assert got["by_wrapper"] == {"rmsnorm": 1, "decode_attention": 1}
    assert got["kernel_nodes"] == 3 and got["by_name"]["nvjet_tst_64x8_64x16_2x1_v_bz_NNT"] == 1
    assert got["memcpy_nodes"] == {"DtoD": 1} and got["other_nodes"] == {"MEMSET": 1}
    bwd = HY.CS.graph_kernel_nodes(_DOT.replace("14rmsnorm_kernel", "18rmsnorm_bwd_kernel"))
    assert bwd["by_wrapper"] == {"rmsnorm_bwd": 1, "decode_attention": 1}

"""The port's analysis modules on the CPU: `analysis/model_math.py` against
the JAX package's, and `analysis/trace.py`'s per-device counts.

The trace counts are exact by construction on small fake tensors: a
product's FLOPs (2 m k n) and bytes (its operands and result), a DTensor
product on rank 0 of a fake (2, 2) group counted by its local op, and the
collectives' bytes by JAX's conventions (`repro/analysis/hlo.py:155-175`):
an all-reduce twice its buffer, a reduce-scatter its operand, an
all-gather its result.
"""
import pytest
import torch

from repro.analysis import model_math as jax_mm
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes_for as jax_shapes_for
from repro_torch.analysis import model_math as mm
from repro_torch.analysis.trace import StepTrace, collective_kind
from repro_torch.configs import ARCH_IDS, InputShape, get_config, shapes_for
from repro_torch.launch.dryrun import fake_world, run_cell


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_math_is_jaxs(arch):
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert mm.param_counts(cfg) == jax_mm.param_counts(jcfg)
    assert mm.n_attn_layers(cfg) == jax_mm.n_attn_layers(jcfg)
    shapes, jshapes = shapes_for(cfg), jax_shapes_for(jcfg)
    assert [s.name for s in shapes] == [s.name for s in jshapes]
    for s, js in zip(shapes, jshapes):
        assert (s.seq_len, s.global_batch, s.kind) == (js.seq_len, js.global_batch, js.kind)
        assert mm.attention_flops(cfg, s) == jax_mm.attention_flops(jcfg, js)
        assert mm.model_flops(cfg, s) == jax_mm.model_flops(jcfg, js)


def _counted(fn):
    """fn(mode) under a StepTrace's counting; returns the mode."""
    mode = StepTrace()
    with mode:
        args = fn(mode, None)
        with mode.counting():
            fn(mode, args)
    return mode


@pytest.mark.parametrize("reps", [1, 10])
def test_trace_counts_products_exactly(reps):
    """One [64, 32] x [32, 48] bf16 product: 2 m k n FLOPs, its operands
    and result in bytes; ten products in a loop ten times: 100 times that."""
    m, k, n = 64, 32, 48
    n_products = 1 if reps == 1 else 10

    def step(mode, args):
        if args is None:
            return ([torch.empty(m, k, dtype=torch.bfloat16) for _ in range(n_products)],
                    torch.empty(k, n, dtype=torch.bfloat16))
        xs, w = args
        for _ in range(reps):
            for x in xs:
                x @ w
    mode = _counted(step)
    count = n_products * reps
    assert mode.flops == count * 2 * m * k * n
    assert mode.bytes == count * 2 * (m * k + k * n + m * n)
    assert mode.kernel_flops == 0 and not any(mode.collective_bytes.values())


def test_trace_counts_rank_0s_share_of_a_split_product():
    """On a fake (2, 2) group: x [64, 32] split over "data" by rows, w [32,
    48] split over "model" by columns; the product's output is split 4 ways
    and rank 0 counts its local [32, 32] x [32, 24] product, a quarter of
    the global op's FLOPs, with no collective."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

        def step(mode, args):
            if args is None:
                x = DTensor.from_local(torch.empty(32, 32), mesh, [Shard(0), Replicate()],
                                       run_check=False)
                w = DTensor.from_local(torch.empty(32, 24), mesh, [Replicate(), Shard(1)],
                                       run_check=False)
                return x, w
            y = args[0] @ args[1]
            assert tuple(y.shape) == (64, 48) and tuple(y.to_local().shape) == (32, 24)
        mode = _counted(step)
    assert mode.flops == 2 * 32 * 32 * 24 == 2 * 64 * 32 * 48 // 4
    assert not any(mode.collective_bytes.values())


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter"])
def test_collective_bytes_follow_jaxs_conventions(kind):
    """A [16, 8] fp32 local buffer on a fake 4-rank ("pod",) mesh: Partial
    -> Replicate is an all-reduce of 512 bytes, counted twice; Shard(0) ->
    Replicate an all-gather whose [64, 8] result is counted; Partial ->
    Shard(0) a reduce-scatter whose [16, 8] operand is counted."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    src, dst, want = {"all-reduce": (Partial(), Replicate(), 2 * 16 * 8 * 4),
                      "all-gather": (Shard(0), Replicate(), 64 * 8 * 4),
                      "reduce-scatter": (Partial(), Shard(0), 16 * 8 * 4)}[kind]
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))

        def step(mode, args):
            if args is None:
                return DTensor.from_local(torch.empty(16, 8), mesh, [src], run_check=False)
            args.redistribute(mesh, [dst])
        mode = _counted(step)
    assert mode.collective_bytes[kind] == want
    assert sum(mode.collective_bytes.values()) == want
    assert mode.collective_calls[kind] == 1


def test_collective_kinds_of_op_names():
    for name, kind in (("_c10d_functional::all_gather_into_tensor", "all-gather"),
                       ("_c10d_functional::all_reduce", "all-reduce"),
                       ("_c10d_functional::reduce_scatter_tensor", "reduce-scatter"),
                       ("_c10d_functional::all_to_all_single", "all-to-all"),
                       ("_dtensor::shard_dim_alltoall", "all-to-all")):
        assert collective_kind(name) == kind


def test_reduced_train_step_kernel_calls_are_dense_train_launches():
    """A reduced chatglm3-6b train step traced on a 1 x 1 mesh calls each
    kernel wrapper's abstract path as often as one real step launches it
    (chip_smoke's `dense_train_launches`: remat per layer, 8 CE chunks),
    and launches nothing."""
    from repro_torch.kernels import launches
    cfg = get_config("chatglm3-6b").reduced()
    before = launches()
    rec = run_cell("chatglm3-6b", InputShape("train", 64, 2, "train"), mesh_shape=(1, 1),
                   device="cpu", reduced=True)
    n = cfg.n_layers
    assert rec["ok"] and launches() == before
    assert rec["kernel_calls"] == {
        "flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
        "flash_attention_bwd_dkv": n, "fused_ce": 16, "fused_ce_bwd": 8,
        "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1}

"""The port's sharding table against the JAX package's, exactly, on the CPU
(no process group: the pure functions take a mesh shape).

Meshes: (2, 2), (4, 1) and (1, 4) from `jax.make_mesh` on the 4 host
devices tests/conftest.py sets, and the production shapes (16, 16) and
(2, 16, 16) through a stand-in with a `.shape` mapping, which is all JAX's
pure functions read.  A JAX spec compares as `tuple(PartitionSpec)`; the
port keeps one param dict a layer, so JAX's spec of a stacked block leaf is
`(None, *port_spec)`, trimmed.  Archs: all ten `ARCH_IDS`, reduced (the
activation and cache specs also at full width, where head counts decide).
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import functools
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ALL_SHAPES
from repro.configs import ARCH_IDS
from repro.configs import InputShape as JaxInputShape
from repro.configs import get_config as jax_get_config
from repro.runtime import sharding as jsh
from repro.runtime.elastic import best_mesh_shape as jax_best_mesh_shape
from repro.runtime.pipeline_par import bubble_fraction as jax_bubble_fraction
from repro.runtime.steps import abstract_params as jax_abstract_params
from repro.runtime.steps import model_axes as jax_model_axes
from repro_torch.configs import InputShape, get_config
from repro_torch.models import init_model
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.elastic import best_mesh_shape
from repro_torch.runtime.pipeline_par import bubble_fraction
from repro_torch.runtime.steps import model_axes

MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4), "16x16": None, "2x16x16": None}
PRODUCTION = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _jax_mesh(name):
    """(the JAX mesh or stand-in, the port's mesh shape)."""
    if name in PRODUCTION:
        return types.SimpleNamespace(shape=dict(PRODUCTION[name])), dict(PRODUCTION[name])
    mesh = jax.make_mesh(MESHES[name], ("data", "model"))
    return mesh, dict(mesh.shape)


def _t(spec):
    return None if spec is None else tuple(spec)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return init_model(get_config(arch).reduced(), torch.Generator().manual_seed(0), "cpu")


def _stacked(tree, blocks):
    """The port's spec tree in JAX's layout: the `blocks` list as one tree
    (every block must give the same specs) with a leading None a leaf."""
    if blocks:
        first = tree[0]
        assert all(t == first for t in tree[1:])
        return _map(lambda s: tuple(_trim((None,) + s)), first)
    if isinstance(tree, dict):
        return {k: _stacked(v, k == "blocks") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked(v, False) for v in tree]
    return tree


def _trim(parts):
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return parts


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _jax_tree(tree):
    """JAX's spec tree with every PartitionSpec as a tuple."""
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jaxs(arch, mesh):
    jmesh, shape = _jax_mesh(mesh)
    jcfg = jax_get_config(arch).reduced()
    want = _jax_tree(jsh.param_specs(jax_abstract_params(jcfg), jax_model_axes(jcfg), jmesh,
                                     jsh.ShardingPolicy()))
    cfg = get_config(arch).reduced()
    got = sh.param_specs(_port_params(arch), model_axes(cfg), shape, sh.ShardingPolicy())
    assert _stacked(got, False) == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("axes,shape", [
    (("embed", "kv_heads", "head_dim"), (128, 3, 64)),
    (("embed", "heads", "head_dim"), (4096, 32, 128)),
    (("vocab", "embed"), (65024, 4096)),
    (("experts", "embed", "mlp"), (64, 2048, 1408)),
    (("heads", "head_dim", "embed"), (48, 128, 6144)),
    ((None, "mlp"), (4, 3072)),
    (("embed", "embed"), (32, 32)),                  # an axis is used once
    (("lora", "heads_nosplit", "experts_nosplit"), (512, 16, 8)),
])
def test_spec_for_equals_jaxs(axes, shape, fsdp, mesh):
    jmesh, ms = _jax_mesh(mesh)
    want = jsh.spec_for(axes, shape, jmesh, jsh.ShardingPolicy(fsdp=fsdp))
    assert sh.spec_for(axes, shape, ms, sh.ShardingPolicy(fsdp=fsdp)) == tuple(want)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_equal_jaxs(mesh):
    jmesh, ms = _jax_mesh(mesh)
    for gb, s in ((8, 128), (1, 128), (3, 5), (256, 4096), (2, 48), (1, 3), (32, 1)):
        assert sh.batch_spec(ms, gb, s) == tuple(jsh.batch_spec(jmesh, gb, s)), (gb, s)
    if mesh in PRODUCTION:      # batch_shardings builds NamedShardings: a real mesh only
        return
    for shp in ALL_SHAPES + (JaxInputShape("tiny", 48, 2, "train"),
                             JaxInputShape("odd", 7, 3, "decode")):
        port_shape = InputShape(shp.name, shp.seq_len, shp.global_batch, shp.kind)
        for dec in (False, True):
            want = {k: tuple(v.spec)
                    for k, v in jsh.batch_shardings(jmesh, shp, for_decode=dec).items()}
            assert sh.batch_shardings(ms, port_shape, for_decode=dec) == want, (shp, dec)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
def test_activation_specs_equal_jaxs(mesh, reduced):
    jmesh, ms = _jax_mesh(mesh)
    for arch in ARCH_IDS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for shp in ALL_SHAPES + (JaxInputShape("tiny", 48, 2, "train"),
                                 JaxInputShape("odd", 6, 3, "prefill")):
            port_shape = InputShape(shp.name, shp.seq_len, shp.global_batch, shp.kind)
            assert sh.activation_spec_for(ms, port_shape) == tuple(
                jsh.activation_spec_for(jmesh, shp))
            for c, jc in ((cfg, jcfg), (None, None)):
                want = {k: _t(v) for k, v in jsh.activation_specs_for(jmesh, shp, jc).items()}
                assert sh.activation_specs_for(ms, port_shape, c) == want, (arch, shp)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
def test_cache_specs_equal_jaxs_for_every_family(mesh, reduced):
    jmesh, ms = _jax_mesh(mesh)
    families = set()
    for arch in ARCH_IDS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        families.add(cfg.family)
        for batch, seq in ((4, 1024), (1, 524288), (3, 96), (32, 32768), (2, 7)):
            want = _jax_tree(jsh.cache_specs(jcfg, jmesh, batch, seq))
            assert sh.cache_specs(cfg, ms, batch, seq) == want, (arch, batch, seq)
    assert {"dense", "moe", "ssm", "hybrid", "vlm", "audio"} <= families


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_axes_equal_jaxs_and_cover_every_param_leaf(arch):
    """The counterpart of tests/test_arch_smoke.py::test_axes_tree_matches_params:
    the port's axes tree has the structure of its params, one tuple of the
    leaf's rank a leaf, and every block's tuples are JAX's."""
    cfg = get_config(arch).reduced()
    axes = model_axes(cfg)
    params = _port_params(arch)

    def walk(p, a, path):
        if isinstance(p, dict):
            assert isinstance(a, dict) and set(a) == set(p), path
            for k in p:
                walk(p[k], a[k], f"{path}.{k}")
        elif isinstance(p, list):
            assert isinstance(a, list) and len(a) == len(p), path
            for i, (pi, ai) in enumerate(zip(p, a)):
                walk(pi, ai, f"{path}.{i}")
        else:
            assert isinstance(a, tuple) and len(a) == p.dim(), path
    walk(params, axes, arch)

    def unstack(t, blocks):
        if blocks:
            assert all(b == t[0] for b in t)
            return t[0]
        if isinstance(t, dict):
            return {k: unstack(v, k == "blocks") for k, v in t.items()}
        return t
    assert unstack(axes, False) == jax_model_axes(jax_get_config(arch).reduced())


def test_placements_of_a_spec():
    """One placement a mesh dim: Shard(d) where entry d names the dim, a
    tensor dim over two axes split in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(("data", None, "model"), mesh) == [Replicate(), Shard(0), Shard(2)]
    assert sh.placements((("pod", "data"), None), mesh) == [Shard(0), Shard(0), Replicate()]
    assert sh.placements((), mesh) == [Replicate()] * 3


def test_misplaced_names_every_leaf_that_is_not_a_dtensor_at_its_spec():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: 2)
    tree = {"a": torch.zeros(4, 2), "b": [torch.zeros(2)], "step": torch.zeros(())}
    specs = {"a": ("data",), "b": [()], "step": None}
    assert sh.misplaced(tree, specs, mesh, prefix="p.") == ["p.a", "p.b.0"]


def test_best_mesh_shape_equals_jaxs_for_every_n():
    for n in range(1, 513):
        assert best_mesh_shape(n) == jax_best_mesh_shape(n), n
        assert best_mesh_shape(n, prefer_model=4) == jax_best_mesh_shape(n, prefer_model=4)


def test_production_mesh_needs_256_or_512_ranks():
    """JAX's shapes and names; without a process group of that many ranks
    it raises before touching a device."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world size of {n}"):
            make_production_mesh(multi_pod=multi_pod)


def test_bubble_fraction_equals_jaxs():
    for s in range(1, 9):
        for m in range(1, 33):
            assert bubble_fraction(s, m) == jax_bubble_fraction(s, m)


@pytest.mark.parametrize("kv_heads,whole", [(1, True), (2, False)])
def test_product_plan_makes_a_split_weight_dim_of_size_1_whole_on_a_mesh_dim_of_size_1(
        kv_heads, whole):
    """wk [d, Hkv, dh] split (data, model) on a 1 x 1 mesh: one kv head is
    made whole on "model" (DTensor's einsum views the dim away), more are
    kept as they are; x's placements are kept either way."""
    from torch.distributed.tensor import Replicate, Shard
    x_pl, w_pl = (Shard(0), Replicate()), (Shard(0), Shard(1))
    plan = sh.product_plan("bsd,dhk->bshk", x_pl, w_pl, (1, 1), (2, 8, 16),
                           (16, kv_heads, 32), 2)
    assert plan.x == x_pl and not plan.row
    assert plan.w == ((Shard(0), Replicate()) if whole else w_pl)

"""Saves and restores of a sharded train state on 4 gloo ranks, on the CPU,
against a plain save of the port, the JAX package's save and its restore.

One spawn of 4 ranks (`_torch_dist_ckpt_ranks.py`, which imports no JAX)
runs every case.  This file first writes, for reduced chatglm3-6b,
mamba2-130m, deepseek-v3-671b (its dense `prefix` and `mtp`) and
jamba-1.5-large-398b (period blocks), a train state of JAX's weights at
their own dtypes carried across with `from_jax_params`, fp32 moments drawn
from a numpy seed and `opt.step` 7; saves it plainly through the port's
manager (run `<arch>-plain`) and through JAX's (run `<arch>-jax`, the same
state in JAX's layout); then the ranks save it sharded on (2, 2) and
restore it (see the rank script).  JAX's manager is duck-typed over its
`lib`: it reads the ranks' directory through the port's `DirLib`.

Everything is bitwise.  Files: the sharded saves' MANIFESTs against the
plain save's leaf by leaf (names, shapes, dtypes, part paths, crc32s) and
every part file byte for byte; against JAX's save the same, but that a
bf16 part's .npy header says `|V2` where JAX's says `<V2`, so its crc is
not compared and its data bytes are.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import io

import jax
import numpy as np
import pytest
import torch

from _torch_dist_ckpt_ranks import (ARCHS, B, MESHES, S, STEP, config, extra, start)
from _torch_dist_families_ranks import WORLD, join
from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import from_jax_params, to_jax_params, to_numpy
from repro_torch.data import DirLib
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_state
from repro_torch.tree import tree_leaves


def _state(arch):
    """JAX's reduced weights as the port's params, fp32 moments from a
    numpy seed (v positive), opt.step 7."""
    jp, _ = jax_init_model(jax_get_config(arch).reduced(), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), config(arch))
    state = make_train_state(config(arch), AdamWConfig(), params=params)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for t in tree_leaves(state["opt"]["m"]):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)))
        for t in tree_leaves(state["opt"]["v"]):
            t.copy_(torch.from_numpy(np.abs(rng.standard_normal(t.shape, np.float32))))
        state["opt"]["step"].fill_(7)
    return state


def _jax_tree(state, cfg):
    """The port's state as JAX's Trainer holds it (numpy, the JAX layout)."""
    return {"params": to_jax_params(state["params"], cfg),
            "opt": {"m": to_jax_params(state["opt"]["m"], cfg),
                    "v": to_jax_params(state["opt"]["v"], cfg),
                    "step": to_numpy(state["opt"]["step"])}}


def _batch(vocab):
    toks = np.random.default_rng(5).integers(1, vocab, (B, S + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1]).long(),
            "labels": torch.as_tensor(toks[:, 1:]).long(),
            "loss_mask": torch.ones(B, S)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the states and their plain and JAX saves, runs the 4 ranks
    once, returns the storage client, the JAX trees, every rank's record
    and each state's number of leaves."""
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    lib = DirLib(str(tmp / "ckpt"))
    inputs, jtrees = {}, {}
    for arch in ARCHS:
        state = _state(arch)
        jtrees[arch] = _jax_tree(state, config(arch))
        CheckpointManager(lib, f"{arch}-plain").save(STEP, state, extra=extra())
        JaxCheckpointManager(lib, f"{arch}-jax").save(STEP, jtrees[arch], extra=extra())
        inputs[arch] = {"state": state, "batch": _batch(config(arch).vocab_size)}
    torch.save(inputs, tmp / "inputs.pt")
    join(start(str(tmp)), timeout=600.0)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"lib": lib, "jax": jtrees, "ranks": ranks,
            "leaves": {a: len(tree_leaves(inputs[a]["state"])) for a in ARCHS}}


def _files(lib, run):
    """{leaf name: (shape, dtype, [(part path in the step, crc, file bytes)])}
    of a run's MANIFEST at STEP, in its order, and its step, parts, extra."""
    man = CheckpointManager(lib, run).manifest(STEP)
    leaves = {lm["name"]: (lm["shape"], lm["dtype"],
                           [(f["path"].split(f"/{run}/", 1)[1], f["crc"],
                             lib.read_file(f["path"])) for f in lm["files"]])
              for lm in man.leaves}
    return (man.step, man.parts, man.extra), leaves


def _npy_data(blob):
    return np.load(io.BytesIO(blob), allow_pickle=False).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ["sync", "async"])
def test_sharded_save_writes_a_plain_saves_files(world, arch, run):
    """A save of the state sharded on (2, 2), blocking and async (a train
    step updating the state in place before `wait()`): the plain save's
    MANIFEST, leaf for leaf, and its files byte for byte; rank 0 wrote
    them all, the other ranks nothing, each rank gathered every sharded
    leaf whole; every rank sees the step after `save` (blocking) or
    `wait()` (async) returns."""
    lib = world["lib"]
    head, got = _files(lib, f"{arch}-{run}")
    want_head, want = _files(lib, f"{arch}-plain")
    assert head == want_head
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(n.startswith("params.blocks.") for n in got) and "opt.step" in got
    if arch == "deepseek-v3-671b":
        assert any(n.startswith("params.prefix.0.") for n in got)
        assert any(n.startswith("params.mtp.") for n in got)
    if arch == "jamba-1.5-large-398b":
        assert any(n.startswith("params.blocks.layers.4.") for n in got)
    total = sum(len(b) for _, _, files in want.values() for _, _, b in files)
    gathered = None
    for r in world["ranks"]:
        rec = r["archs"][arch]
        assert rec["sharded_leaves"] > 0
        assert rec[run]["latest"] == STEP
        save = rec[run]["save"]
        gathered = gathered or save["gathered_bytes"]
        assert save["gathered_bytes"] == gathered > 0
        if r["rank"] == 0:
            assert save["files"] == sum(len(f) for _, _, f in want.values()) + 1
            assert save["bytes"] > total and save["leaves"] == len(want)
        else:
            assert save["files"] == save["bytes"] == 0
        if run == "async":
            # the step changed the params in place (a bf16 norm scale near 1
            # may keep its value: the update is under its ulp); the files are
            # the state before it
            assert rec["async"]["in_place"]
            assert rec["async"]["params_changed"] > rec["async"]["params"] // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_save_is_jaxs_save_and_jax_restores_it(world, arch):
    """The sharded save against JAX's save of the same state: names, shapes,
    dtypes, part paths; each part's crc32 and bytes (a bf16 part's data
    bytes); and JAX's `CheckpointManager.restore(like=...)` of the sharded
    save gives the JAX state bitwise."""
    lib = world["lib"]
    head, got = _files(lib, f"{arch}-sync")
    jhead, want = _files(lib, f"{arch}-jax")
    assert head == jhead and list(got) == list(want)
    for name, (shape, dtype, files) in want.items():
        gshape, gdtype, gfiles = got[name]
        assert (gshape, gdtype) == (shape, dtype), name
        assert [p for p, _, _ in gfiles] == [p for p, _, _ in files], name
        if dtype == "bfloat16":
            assert [_npy_data(b) for _, _, b in gfiles] == [_npy_data(b) for _, _, b in files]
        else:
            assert gfiles == files, name
    jtree = world["jax"][arch]
    _, restored = JaxCheckpointManager(lib, f"{arch}-sync").restore(like=jtree)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            jax.tree_util.tree_leaves(restored)):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert g.tobytes() == w.tobytes(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", [(m, like, "sync") for m in MESHES for like in ("dtensor", "fake")]
                         + [((2, 2), "dtensor", "jax")], ids=str)
def test_elastic_restore_places_each_rank_its_shard_bitwise(world, arch, case):
    """`elastic_restore` of the sharded save onto (2, 2), (1, 4) and (4, 1)
    from a like_state of DTensors and of fake tensors, and of JAX's save
    onto (2, 2): on every rank each leaf's local shard bitwise its slice of
    the state, with its dtype and requires_grad; every leaf at its spec's
    placements; `opt.step` plain; the sampler at the saved train step."""
    for r in world["ranks"]:
        rec = r["archs"][arch]["restore"][case]
        assert rec["wrong"] == [] and rec["misplaced"] == []
        assert rec["opt_step_plain"] and rec["step"] == STEP
        assert rec["sampler"] == {"step": STEP, "seed": 11}
        assert rec["partial"] > 0 and rec["leaves"] == world["leaves"][arch]


# ---------------------------------------------------------------------------
# refusals, on a one-rank gloo group in this process
# ---------------------------------------------------------------------------

@pytest.fixture()
def world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _one_rank_tree():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    tree = {"blocks": [{"w": distribute_tensor(torch.randn(4, 6, generator=g), mesh,
                                               [Shard(0), Replicate()])} for _ in range(3)],
            "b": distribute_tensor(torch.randn(8, generator=g), mesh, [Replicate(), Shard(0)]),
            "step": torch.tensor(5, dtype=torch.int32)}
    return mesh, tree


def test_a_stack_of_mixed_placements_or_a_partial_leaf_is_refused(world_of_one, tmp_path):
    """Restoring into a stack whose blocks differ in placements, or into a
    `Partial` placement, raises; the same save restores into the tree's own
    layout bitwise (DTensors at their placements, the plain leaf plain)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    mesh, tree = _one_rank_tree()
    mgr = CheckpointManager(DirLib(str(tmp_path / "ck")), "one", parts=2)
    mgr.save(1, tree)
    _, got = mgr.restore(like=tree)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert type(a) is type(b) and torch.equal(a.full_tensor() if isinstance(a, DTensor)
                                                  else a, b.full_tensor()
                                                  if isinstance(b, DTensor) else b)
        assert not isinstance(a, DTensor) or a.placements == b.placements
    mixed = dict(tree, blocks=[dict(w=b["w"]) for b in tree["blocks"]])
    mixed["blocks"][1] = {"w": distribute_tensor(torch.zeros(4, 6), mesh,
                                                 [Replicate(), Shard(1)])}
    with pytest.raises(ValueError, match="differ in placements"):
        mgr.restore(like=mixed)
    partial = dict(tree, b=DTensor.from_local(torch.zeros(8), mesh, [Partial(), Replicate()]))
    with pytest.raises(ValueError, match="placement"):
        mgr.restore(like=partial)


def test_a_failed_gather_or_write_commits_no_step(world_of_one, tmp_path, monkeypatch):
    """A gather that raises makes `save` raise before any MANIFEST; a write
    that fails on the async writer makes `wait()` raise, and the step stays
    invisible; leaves on two meshes are refused."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    mesh, tree = _one_rank_tree()
    lib = DirLib(str(tmp_path / "ck"))
    mgr = CheckpointManager(lib, "one")

    def refuse(self):
        raise RuntimeError("gather refused")
    with monkeypatch.context() as m:
        m.setattr(DTensor, "full_tensor", refuse)
        for block in (True, False):
            with pytest.raises(RuntimeError, match="gather refused"):
                mgr.save(1, tree, block=block)
    assert mgr.latest_step() is None
    real = lib.write_file

    def fail_on_npy(path, data):
        if path.endswith(".npy"):
            raise OSError("disk full")
        return real(path, data)
    monkeypatch.setattr(lib, "write_file", fail_on_npy)
    mgr.save(2, tree, block=False)
    with pytest.raises(IOError):
        mgr.wait()
    assert mgr.latest_step() is None
    monkeypatch.setattr(lib, "write_file", real)
    mgr.save(3, tree, block=False)
    mgr.wait()
    assert mgr.latest_step() == 3
    other = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    two = dict(tree, c=distribute_tensor(torch.zeros(2), other, [Replicate()]))
    with pytest.raises(ValueError, match="more than one mesh"):
        mgr.save(4, two)

"""The port's checkpoints against the JAX package's, on the CPU.

`repro_torch.ckpt.CheckpointManager` writes what `repro.ckpt` writes: the
same leaf names (the JAX layout: per-layer dicts stacked to `[L, ...]`),
MANIFEST, part split and crc32s, bf16 as 2-byte void records.  Here: the
six checkpoint tests of tests/test_data_and_ckpt.py on the port's manager,
each over a real BLib (a 2-BServer `BuffetCluster` in `tmp_path`) and over
`DirLib`; the layout leaf by leaf against a JAX save of the same state for
every family `convert.py` carries (dense, moe with its `prefix`, v3's
`mtp`, ssm, hybrid); a bf16 save and restore in a process where
`ml_dtypes` and JAX cannot load; a JAX Trainer's checkpoint resumed by the
port's Trainer and a port Trainer's restored by JAX, bitwise.  (The port's
4 + 4 resumed run against 8 steps uninterrupted is in test_torch_data.py.)
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.core import BAgent, BLib, BuffetCluster
from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime.steps import make_train_state as jax_make_train_state
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_numpy
from repro_torch.data import DirLib
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.models import loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_state
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL_F32 = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_train.py's


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these steps are tiny, and the suite runs its
    files in parallel workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cluster(tmp_path):
    c = BuffetCluster(root_dir=str(tmp_path / "bfs"), n_servers=2)
    yield c
    c.shutdown()


@pytest.fixture(params=["blib", "dirlib"])
def lib(request, cluster, tmp_path):
    if request.param == "dirlib":
        yield DirLib(str(tmp_path / "dir"))
        return
    agent = BAgent(cluster)
    yield BLib(agent)
    agent.shutdown()


# ---------------------------------------------------------------------------
# tests/test_data_and_ckpt.py's checkpoint tests, on the port's manager
# ---------------------------------------------------------------------------

def _tree():
    return {
        "w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
        "b": torch.ones(8),
        "inner": {"scale": 2.5 * torch.ones(4, 2)},
    }


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_ckpt_save_restore_roundtrip(lib):
    mgr = CheckpointManager(lib, "runA", parts=4, keep_last=10)
    tree = _tree()
    mgr.save(10, tree, extra={"lr": 0.1})
    step, restored = mgr.restore(like=_tree())
    assert step == 10
    assert _equal(restored["w"], tree["w"])
    assert _equal(restored["inner"]["scale"], tree["inner"]["scale"])
    assert mgr.manifest(10).extra["lr"] == 0.1


def test_ckpt_async_save(lib):
    mgr = CheckpointManager(lib, "runB", parts=2)
    tree = _tree()
    mgr.save(1, tree, block=False)
    # the copy to the host is done when save returns: an in-place update
    # (what AdamW does next) does not reach the checkpoint
    tree["b"].add_(1.0)
    mgr.wait()
    step, restored = mgr.restore(like=_tree())
    assert step == 1
    assert _equal(restored["b"], torch.ones(8))
    rec = mgr.saves[-1]
    assert rec["files"] == 3 * 2 + 1 and rec["bytes"] > 0 and rec["write_s"] >= 0


def test_ckpt_latest_and_gc(lib):
    mgr = CheckpointManager(lib, "runC", parts=2, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]  # older steps GC'd
    assert list(lib.walk_files(mgr._step_dir(1))) == []


def test_ckpt_uncommitted_invisible(lib):
    mgr = CheckpointManager(lib, "runD", parts=2)
    mgr.save(5, _tree())
    # simulate a torn save: step dir exists but no MANIFEST
    sdir = mgr._step_dir(9)
    lib.makedirs(f"{sdir}/part_000")
    lib.write_file(f"{sdir}/part_000/w.npy", b"garbage")
    assert mgr.latest_step() == 5


def test_ckpt_elastic_parts(lib):
    """Save with 4 parts, restore through a manager configured differently —
    restore is driven by the manifest, not the current config."""
    m4 = CheckpointManager(lib, "runE", parts=4)
    tree = _tree()
    m4.save(7, tree)
    m1 = CheckpointManager(lib, "runE", parts=1)
    step, restored = m1.restore(like=_tree())
    assert _equal(restored["w"], tree["w"])
    assert [(lm["name"], len(lm["files"])) for lm in m1.manifest(7).leaves] == [
        ("b", 4), ("inner.scale", 4), ("w", 4)]


def test_ckpt_corruption_detected(lib):
    mgr = CheckpointManager(lib, "runF", parts=1)
    mgr.save(3, _tree())
    man = mgr.manifest(3)
    victim = man.leaves[0]["files"][0]["path"]
    lib.write_file(victim, b"corrupted bytes")
    with pytest.raises(IOError):
        mgr.restore(3, like=_tree())


# ---------------------------------------------------------------------------
# the layout: the port's save of a state against JAX's save of the same state
# ---------------------------------------------------------------------------

def _port_state(arch, moment_dtype=torch.float32, seed=0):
    cfg = get_config(arch).reduced()
    opt = AdamWConfig(moment_dtype=moment_dtype)
    state = make_train_state(cfg, opt, torch.Generator().manual_seed(seed))
    with torch.no_grad():   # moments and step that are not zeros
        for t in tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"]):
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(t.numel())))
        state["opt"]["step"].fill_(7)
    return cfg, state


def _jax_tree(state, cfg):
    """The port's state as the JAX Trainer holds it (numpy, the JAX layout)."""
    return {"params": to_jax_params(state["params"], cfg),
            "opt": {"m": to_jax_params(state["opt"]["m"], cfg),
                    "v": to_jax_params(state["opt"]["v"], cfg),
                    "step": to_numpy(state["opt"]["step"])}}


@pytest.mark.parametrize("arch,moments", [
    ("stablelm-3b", "float32"), ("mamba2-130m", "float32"),
    ("deepseek-v2-lite-16b", "bfloat16"), ("deepseek-v3-671b", "float32"),
    ("jamba-1.5-large-398b", "bfloat16")])
def test_layout_is_jaxs_and_each_restores_the_other(cluster, arch, moments):
    """The port's save and JAX's save of the same state: the same MANIFEST
    (leaf names in JAX's order, shapes, dtypes, relative part paths, parts;
    the crcs and bytes of every file but a bf16 one, whose .npy header says
    `|V2` where JAX's says `<V2`), and each restores the other's bitwise."""
    agent = BAgent(cluster)
    lib = BLib(agent)
    cfg, state = _port_state(arch, getattr(torch, moments))
    jtree = _jax_tree(state, cfg)
    port, jaxm = CheckpointManager(lib, "port"), JaxCheckpointManager(lib, "jax")
    port.save(3, state, extra={"train_step": 3})
    jaxm.save(3, jtree, extra={"train_step": 3})
    pm, jm = port.manifest(3), jaxm.manifest(3)
    assert (pm.step, pm.parts, pm.extra) == (jm.step, jm.parts, jm.extra)
    assert [lm["name"] for lm in pm.leaves] == [lm["name"] for lm in jm.leaves]
    names = {lm["name"] for lm in pm.leaves}
    assert "opt.step" in names
    for tree_name in ("params", "opt.m", "opt.v"):
        assert any(n.startswith(f"{tree_name}.blocks.") for n in names), tree_name
    if "prefix" in jtree["params"]:
        assert any(n.startswith("params.prefix.0.") for n in names)
    for p, j in zip(pm.leaves, jm.leaves):
        assert (p["shape"], p["dtype"]) == (j["shape"], j["dtype"]), p["name"]
        assert [f["path"].replace("/ckpt/port/", "") for f in p["files"]] == \
            [f["path"].replace("/ckpt/jax/", "") for f in j["files"]], p["name"]
        if p["dtype"] != "bfloat16":
            assert [f["crc"] for f in p["files"]] == [f["crc"] for f in j["files"]]
    # JAX restores the port's files; the port restores JAX's
    _, jgot = JaxCheckpointManager(lib, "port").restore(like=jtree)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jtree),
                                 jax.tree_util.tree_leaves(jgot)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            jax.tree_util.keystr(path)
    _, pgot = CheckpointManager(lib, "jax").restore(like=_port_state(arch, getattr(
        torch, moments), seed=1)[1])
    for a, b in zip(tree_leaves(pgot), tree_leaves(state)):
        assert _equal(a, b.detach())
    assert all(t.requires_grad for t in tree_leaves(pgot["params"]))
    agent.shutdown()


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # an import of it raises ImportError
sys.modules["jax"] = None
import torch
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DirLib
tree = {"blocks": [{"w": torch.randn(3, 5).bfloat16()} for _ in range(2)],
        "embed": {"tok": torch.randn(6, 4).bfloat16()}, "s": torch.tensor(2.5).bfloat16()}
mgr = CheckpointManager(DirLib(sys.argv[1]), "bf16", parts=2)
mgr.save(1, tree, block=False)
mgr.wait()
like = {"blocks": [{"w": torch.zeros(3, 5, dtype=torch.bfloat16)} for _ in range(2)],
        "embed": {"tok": torch.zeros(6, 4, dtype=torch.bfloat16)},
        "s": torch.zeros((), dtype=torch.bfloat16)}
_, got = mgr.restore(like=like)
ok = all(torch.equal(got["blocks"][i]["w"], tree["blocks"][i]["w"]) for i in range(2))
ok = ok and torch.equal(got["embed"]["tok"], tree["embed"]["tok"])
ok = ok and torch.equal(got["s"], tree["s"])
head = open(sys.argv[1] + "/ckpt/bf16/step_00000001/part_000/blocks.w.npy", "rb").read(60)
print(ok, "|V2" in head.decode("latin1"), [m for m in sys.modules
      if m.split(".")[0] in ("ml_dtypes", "jax", "repro") and sys.modules[m] is not None])
"""


def test_bf16_save_and_restore_without_ml_dtypes_or_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "[]"]


# ---------------------------------------------------------------------------
# across frameworks: the Trainers
# ---------------------------------------------------------------------------

ACROSS = ["stablelm-3b", "mamba2-130m"]


def _fixed_batch(vocab, b=2, s=32, seed=5):
    toks = np.random.default_rng(seed).integers(1, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}


@pytest.mark.parametrize("arch", ACROSS)
def test_port_trainer_resumes_a_jax_trainers_checkpoint(tmp_path, arch):
    """A JAX Trainer (2 steps, ckpt_every 2) saves; the port's Trainer over a
    BLib on the same cluster directory restores it: step 2, params and
    moments bitwise `from_jax_params` of JAX's state, and its loss on a
    fixed batch JAX's loss_fn's on the restored state (both cast to fp32)."""
    from repro.launch.train import Trainer as JaxTrainer
    from repro.launch.train import TrainerConfig as JaxTrainerConfig
    data_dir = str(tmp_path / "bfs")
    jtr = JaxTrainer(JaxTrainerConfig(arch=arch, steps=2, global_batch=2, seq_len=16,
                                      ckpt_every=2, log_every=100, n_servers=2,
                                      data_dir=data_dir, run_name="x"))
    jtr.run()
    jstate = jax.tree_util.tree_map(np.asarray, jtr.state)
    jcfg = jtr.cfg
    jtr.shutdown()

    cluster = BuffetCluster(root_dir=data_dir, n_servers=2)
    agent = BAgent(cluster)
    try:
        tr = Trainer(TrainerConfig(arch=arch, steps=4, global_batch=2, seq_len=16,
                                   run_name="x", device="cpu"), lib=BLib(agent))
        tr.init_or_restore()
        assert tr.start_step == 2 and tr.sampler.step == 2
        cfg = tr.cfg
        for key in ("params",):
            want = from_jax_params(jstate[key], cfg)
            for a, b in zip(tree_leaves(tr.state[key]), tree_leaves(want)):
                assert _equal(a.detach(), b)
        for key in ("m", "v"):
            want = from_jax_params(jstate["opt"][key], cfg)
            for a, b in zip(tree_leaves(tr.state["opt"][key]), tree_leaves(want)):
                assert _equal(a, b)
        assert tr.state["opt"]["step"].dtype == torch.int32
        assert int(tr.state["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
        batch = _fixed_batch(cfg.vocab_size)
        p32 = tree_map(lambda t: t.detach().float(), tr.state["params"])
        loss, _ = loss_fn(p32, {k: torch.as_tensor(v).long() if k != "loss_mask"
                                else torch.as_tensor(v) for k, v in batch.items()}, cfg)
        jp32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                      jstate["params"])
        jloss, _ = jax_loss_fn(jp32, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL_F32)
        tr.shutdown()
    finally:
        agent.shutdown()
        cluster.shutdown()


@pytest.mark.parametrize("arch", ACROSS)
def test_jax_restores_a_port_trainers_checkpoint(cluster, arch):
    """The port's Trainer saves (2 steps, ckpt_every 2); JAX's
    CheckpointManager restores it like `make_train_state`: the same leaf
    names, and every leaf bitwise `to_jax_params` of the port's state."""
    agent = BAgent(cluster)
    lib = BLib(agent)
    tr = Trainer(TrainerConfig(arch=arch, steps=2, global_batch=2, seq_len=16,
                               ckpt_every=2, run_name="p", device="cpu"), lib=lib)
    tr.run()
    tr.shutdown()
    want = _jax_tree(tr.state, tr.cfg)
    like = jax_make_train_state(jax_get_config(arch).reduced(), JaxAdamWConfig(),
                                jax.random.PRNGKey(0))
    mgr = JaxCheckpointManager(lib, "p")
    assert mgr.steps() == [2]
    names = [lm["name"] for lm in mgr.manifest(2).leaves]
    assert names == [jax.tree_util.keystr(p).replace("'", "").replace("[", ".")
                     .replace("]", "").strip(".")
                     for p, _ in jax.tree_util.tree_leaves_with_path(like)]
    step, got = mgr.restore(like=like)
    assert step == 2
    jax.tree_util.tree_map(lambda *a: None, got, want)      # the same structure
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert g.tobytes() == w.tobytes(), jax.tree_util.keystr(path)
    agent.shutdown()

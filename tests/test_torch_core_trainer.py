"""The port's Trainer on its own BuffetFS, on the CPU.

Given no storage client, the Trainer builds what the JAX Trainer builds: a
`repro_torch.core.BuffetCluster` of `tc.n_servers` servers over
`tc.data_dir` (a temp dir when none is given), a `BAgent` and a `BLib`, and
reports the agent's critical and async RPCs.  A new Trainer over the same
`data_dir` restarts the servers and resumes (the port of
tests/test_runtime.py::test_trainer_crash_restart_resumes).  The directory
a JAX Trainer leaves is resumed by the port's Trainer, bitwise, and the one
the port's Trainer leaves is restored by JAX's `CheckpointManager` over
JAX's cluster.  One epoch read sample by sample costs the same RPCs in
both packages.  A cluster that cannot start raises; nothing falls back to
`DirLib`.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import BuffetDataset as JaxBuffetDataset
from repro.data import ShardedSampler as JaxShardedSampler
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime.steps import make_train_state as jax_make_train_state
from repro_torch.convert import from_jax_params, to_jax_params, to_numpy
from repro_torch.data import BuffetDataset, DirLib, ShardedSampler
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

ARCH = "mamba2-130m"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these steps are tiny, and the suite runs its
    files in parallel workers, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc(**kw):
    base = dict(arch=ARCH, steps=4, global_batch=2, seq_len=16, ckpt_every=2, log_every=100,
                run_name="r", device="cpu")
    return TrainerConfig(**{**base, **kw})


def test_trainer_without_a_lib_runs_over_four_port_servers():
    """The default storage: 4 servers of the port's cluster in a temp dir,
    an agent, a BLib; the run reports the agent's RPCs (the samples read
    with no open RPC); `shutdown` stops the agent and the cluster and
    removes the temp dir."""
    tr = Trainer(_tc())
    assert TrainerConfig().n_servers == 4
    assert type(tr.cluster) is port_core.BuffetCluster and len(tr.cluster.servers) == 4
    assert type(tr.agent) is port_core.BAgent and type(tr.lib) is port_core.BLib
    assert tr.lib.agent is tr.agent and tr.agent.cluster is tr.cluster
    assert not isinstance(tr.lib, DirLib)
    root = tr.cluster.root_dir
    assert sorted(os.listdir(root)) == [f"bserver{i}" for i in range(4)]
    out = tr.run()
    assert out["critical_rpcs"] > 0 and out["async_rpcs"] > 0
    tr.agent.drain()
    snap = tr.agent.stats.snapshot()
    assert snap["by_type"]["READ"] >= 4 * 2 and "OPEN_RECORD" not in snap["by_type"]
    # the corpus spread over the servers: at least two hold objects
    held = [h for h, s in tr.cluster.servers.items()
            if os.listdir(os.path.join(s.backing_dir, "objs"))]
    assert len(held) >= 2
    tr.shutdown()
    assert not os.path.exists(root)


def test_trainer_crash_restart_resumes_over_its_own_cluster(tmp_path):
    """Port of tests/test_runtime.py::test_trainer_crash_restart_resumes:
    a Trainer over `data_dir` with 2 servers runs 10 steps (checkpoints at 5
    and 10) and shuts down; a new Trainer over the same directory, so a new
    cluster that restarts the servers from their meta.json, resumes at step
    10 and runs the 2 steps left."""
    def tc(steps):
        return TrainerConfig(arch="stablelm-3b", steps=steps, global_batch=4, seq_len=32,
                             ckpt_every=5, log_every=100, run_name="cr", device="cpu",
                             data_dir=str(tmp_path), n_servers=2)
    tr = Trainer(tc(10))
    tr.run()
    tr.shutdown()
    assert tr.ckpt.steps() == [5, 10]
    assert sorted(os.listdir(tmp_path)) == ["bserver0", "bserver1"]
    assert all(os.path.isfile(tmp_path / f"bserver{i}" / "meta.json") for i in range(2))

    tr2 = Trainer(tc(12))
    assert tr2.cluster is not tr.cluster and len(tr2.cluster.servers) == 2
    tr2.init_or_restore()
    assert tr2.start_step == 10
    assert tr2.sampler.step == tr2.sampler.state_dict()["step"] == 10
    out = tr2.run()
    tr2.shutdown()
    assert len(out["losses"]) == 2 and np.isfinite(out["final_loss"])
    assert out["critical_rpcs"] > 0
    assert os.path.isdir(tmp_path / "bserver0")       # data_dir is the caller's


def test_port_trainer_without_a_lib_resumes_a_jax_trainers_directory(tmp_path):
    """A JAX Trainer (2 servers, 2 steps, ckpt_every 2) leaves its cluster
    directory; the port's Trainer with no lib and the same n_servers opens
    it with its own servers and restores step 2: params and moments
    bitwise `from_jax_params` of JAX's state, and the sampler there."""
    from repro.launch.train import Trainer as JaxTrainer
    from repro.launch.train import TrainerConfig as JaxTrainerConfig
    data_dir = str(tmp_path / "bfs")
    jtr = JaxTrainer(JaxTrainerConfig(arch=ARCH, steps=2, global_batch=2, seq_len=16,
                                      ckpt_every=2, log_every=100, n_servers=2,
                                      data_dir=data_dir, run_name="x"))
    jtr.run()
    jstate = jax.tree_util.tree_map(np.asarray, jtr.state)
    jtr.shutdown()
    tr = Trainer(_tc(run_name="x", data_dir=data_dir, n_servers=2))
    try:
        assert type(tr.cluster) is port_core.BuffetCluster
        assert len(tr.dataset) == 128          # JAX's corpus, found and reused
        tr.init_or_restore()
        assert tr.start_step == 2 and tr.sampler.step == 2
        for key, got in (("params", tr.state["params"]), ("m", tr.state["opt"]["m"]),
                         ("v", tr.state["opt"]["v"])):
            tree = jstate["params"] if key == "params" else jstate["opt"][key]
            for a, b in zip(tree_leaves(got), tree_leaves(from_jax_params(tree, tr.cfg))):
                a = a.detach()
                assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert int(tr.state["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
        out = tr.run()
        assert len(out["losses"]) == 2 and out["critical_rpcs"] > 0
    finally:
        tr.shutdown()


def test_jax_restores_what_the_port_trainer_left_on_its_cluster(tmp_path):
    """The port's Trainer with no lib saves at step 2 over `data_dir` and
    shuts down; JAX's cluster over that directory and JAX's
    `CheckpointManager` restore the save, every leaf bitwise
    `to_jax_params` of the port's state."""
    data_dir = str(tmp_path / "bfs")
    tr = Trainer(_tc(steps=2, run_name="p", data_dir=data_dir, n_servers=2))
    tr.run()
    tr.shutdown()
    want = {"params": to_jax_params(tr.state["params"], tr.cfg),
            "opt": {"m": to_jax_params(tr.state["opt"]["m"], tr.cfg),
                    "v": to_jax_params(tr.state["opt"]["v"], tr.cfg),
                    "step": to_numpy(tr.state["opt"]["step"])}}
    like = jax_make_train_state(jax_get_config(ARCH).reduced(), JaxAdamWConfig(),
                                jax.random.PRNGKey(0))
    c = jax_core.BuffetCluster(root_dir=data_dir, n_servers=2)
    agent = jax_core.BAgent(c)
    try:
        mgr = JaxCheckpointManager(jax_core.BLib(agent), "p")
        assert mgr.steps() == [2]
        step, got = mgr.restore(like=like)
    finally:
        agent.shutdown()
        c.shutdown()
    assert step == 2
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert g.tobytes() == w.tobytes(), jax.tree_util.keystr(path)


def test_an_epoch_read_sample_by_sample_costs_the_same_rpcs(tmp_path):
    """The same corpus built in a cluster of each package, its shard
    directories warmed, the agent drained and reset; one epoch read sample
    by sample in the sampler's order (no prefetch thread, so no read runs
    ahead): the same samples and the same RPC snapshot, one READ and one
    async CLOSE a sample."""
    rng = np.random.default_rng(3)
    corpus = [rng.integers(1, 1000, size=33).astype(np.uint32) for _ in range(48)]
    got = {}
    for name, P, DS, SS in (("jax", jax_core, JaxBuffetDataset, JaxShardedSampler),
                            ("port", port_core, BuffetDataset, ShardedSampler)):
        c = P.BuffetCluster(root_dir=str(tmp_path / name), n_servers=4)
        agent = P.BAgent(c, client_id="ingest")
        try:
            ds = DS.build(P.BLib(agent), corpus, name="e", shard_size=16)
            ds.warm_dirs()
            agent.drain()
            agent.stats.reset()
            sampler = SS(n_samples=len(ds), global_batch=8, dp_rank=0, dp_size=1)
            samples = [ds.read_sample(i) for step in range(sampler.steps_per_epoch)
                       for i in sampler.indices_for_step(step)]
            agent.drain()
            snap = agent.stats.snapshot()
        finally:
            agent.shutdown()
            c.shutdown()
        got[name] = ([s.tobytes() for s in samples],
                     {k: v for k, v in snap.items() if not k.endswith("_ns")})
    assert got["port"] == got["jax"]
    snap = got["port"][1]
    assert snap["by_type"] == {"READ": 48, "CLOSE": 48}
    assert (snap["critical_path"], snap["async_offpath"]) == (48, 48)


def test_a_cluster_that_cannot_start_raises_and_nothing_falls_back(tmp_path):
    """`data_dir` names a file: the servers' backing directories cannot be
    made, and the Trainer raises; it builds no DirLib."""
    bad = tmp_path / "a_file"
    bad.write_bytes(b"x")
    with pytest.raises(OSError):
        Trainer(_tc(data_dir=str(bad)))
    with pytest.raises(OSError):
        Trainer(_tc(data_dir=str(bad), n_servers=2))
    assert bad.read_bytes() == b"x"

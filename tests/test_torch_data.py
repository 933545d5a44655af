"""The port's BuffetFS data path against the JAX package's, on the CPU.

Both run over one real `BuffetCluster` (2 BServers in `tmp_path`, the
in-process transport) through `repro.core.BLib` clients: the record format
both ways, the corpus files and INDEX that `BuffetDataset.build` writes
(the port's also through `DirLib`, its local-directory client), the port
reading a corpus JAX built, `DataPipeline`'s batches and the RPCs they cost
after the shard directories are warmed, hedged reads past a slow and a dead
BServer; the port's Trainer over the pipeline (the loss falls, a restart
resumes at the checkpoint's step, the RPC report, a run stopped and
resumed is the uninterrupted run bit for bit).
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import time

import numpy as np
import pytest
import torch

from repro.core import BAgent, BLib, BuffetCluster
from repro.core.failure import server_down, slow_server
from repro.core.inode import Inode
from repro.data import BuffetDataset as JaxBuffetDataset
from repro.data import DataPipeline as JaxDataPipeline
from repro.data import ShardedSampler as JaxShardedSampler
from repro.data import decode_sample as jax_decode_sample
from repro.data import encode_sample as jax_encode_sample
from repro_torch.data import (BuffetDataset, DataPipeline, DirLib, ShardedSampler,
                              decode_sample, encode_sample)
from repro_torch.data import tokens as port_tokens
from repro_torch.launch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves


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


@pytest.fixture()
def agent(cluster):
    a = BAgent(cluster)
    yield a
    a.shutdown()


@pytest.fixture()
def cluster4(tmp_path):
    """4 BServers, as tests/test_data_and_ckpt.py's hedged reads run: a
    shard directory and its replica land on different servers."""
    c = BuffetCluster(root_dir=str(tmp_path / "bfs4"), n_servers=4)
    yield c
    c.shutdown()


def _samples(n=40, seq=24, dtype=np.uint16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, size=int(rng.integers(seq // 2, seq + 1))).astype(dtype)
            for _ in range(n)]


def _host(agent, path):
    return Inode.unpack(agent.stat_cached(path)["ino"]).host_id


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int64])
def test_sample_codec_matches_jax_both_ways(dtype):
    s = (np.arange(77) * 13 % 1000).astype(dtype)
    assert encode_sample(s) == jax_encode_sample(s)
    assert port_tokens.MAGIC == 0xB0FFE7F5 and port_tokens._HDR.format == "<IHBBI"
    for blob in (encode_sample(s), jax_encode_sample(s)):
        a, b = decode_sample(blob), jax_decode_sample(blob)
        assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(a, s)
    with pytest.raises(ValueError):
        decode_sample(b"\0" * 12)


def _tree_bytes(lib, root):
    return {p[len(root):]: lib.read_file(p) for p in lib.walk_files(root)}


@pytest.mark.parametrize("client", ["blib", "dirlib"])
@pytest.mark.parametrize("replicate", [False, True])
def test_build_writes_jax_paths_bytes_and_index(agent, tmp_path, replicate, client):
    """The same corpus built by JAX (under /jax) and by the port (under
    /port, through a BLib on the same cluster or through DirLib): the same
    relative paths, the same bytes, the same INDEX."""
    lib = BLib(agent)
    samples = _samples()
    JaxBuffetDataset.build(lib, samples, root="/jax", name="c", shard_size=16,
                           replicate=replicate)
    port_lib = lib if client == "blib" else DirLib(str(tmp_path / "dir"))
    ds = BuffetDataset.build(port_lib, samples, root="/port", name="c", shard_size=16,
                             replicate=replicate)
    want, got = _tree_bytes(lib, "/jax"), _tree_bytes(port_lib, "/port")
    assert sorted(got) == sorted(want)
    assert got == want
    n_files = 40 * (2 if replicate else 1) + 1
    assert len(got) == n_files and "/c/INDEX" in got
    assert ("/c/replica_0002/s_000007.tok" in got) == replicate
    assert ds.spec.samples_per_shard == [16, 16, 8]


def test_port_reads_a_corpus_jax_built(agent):
    lib = BLib(agent)
    samples = _samples(dtype=np.uint32)
    jds = JaxBuffetDataset.build(lib, samples, name="c", shard_size=16, replicate=True)
    ds = BuffetDataset(lib, name="c")
    assert len(ds) == len(jds) == 40 and ds.spec.__dict__ == jds.spec.__dict__
    for i in range(40):
        assert ds.sample_path(i) == jds.sample_path(i)
        for replica in (False, True):
            got = ds.read_sample(i, replica=replica)
            assert got.dtype == np.uint32 and np.array_equal(got, samples[i])


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def _settle(pipe, n, timeout=10.0):
    """Wait until the producer has built `n` batches (and no more come)."""
    t_end = time.time() + timeout
    while pipe.stats.batches < n and time.time() < t_end:
        time.sleep(0.005)
    time.sleep(0.05)
    assert pipe.stats.batches == n, pipe.stats


def test_pipeline_batches_and_rpcs_match_jax(cluster):
    """Over a corpus JAX built, with the same sampler seed: the first 4
    batches bitwise equal, and, each pipeline on its own fresh agent after
    warming, the same RPCs by type for the batches read (the 4 taken, 1
    queued, 1 built and waiting for room: prefetch 1)."""
    setup = BAgent(cluster)
    JaxBuffetDataset.build(BLib(setup), _samples(n=48, seq=40), name="c", shard_size=16)
    setup.drain()
    setup.shutdown()
    got = {}
    for side, (Dataset, Sampler, Pipeline) in {
            "jax": (JaxBuffetDataset, JaxShardedSampler, JaxDataPipeline),
            "port": (BuffetDataset, ShardedSampler, DataPipeline)}.items():
        agent = BAgent(cluster)
        ds = Dataset(BLib(agent), name="c")
        sampler = Sampler(n_samples=len(ds), global_batch=4, dp_rank=0, dp_size=1, seed=3)
        pipe = Pipeline(ds, sampler, seq_len=32, prefetch=1, io_threads=2)
        ds.warm_dirs()
        agent.drain()
        agent.stats.reset()
        it = iter(pipe)
        batches = [next(it) for _ in range(4)]
        _settle(pipe, 6)
        pipe.stop()
        agent.drain()
        got[side] = (batches, agent.stats.snapshot()["by_type"], pipe.stats.samples)
        agent.shutdown()
    (jb, jrpc, jn), (pb, prpc, pn) = got["jax"], got["port"]
    for j, p in zip(jb, pb):
        assert sorted(p) == sorted(j) == ["labels", "loss_mask", "tokens"]
        for k in j:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape == (4, 32), k
            assert p[k].tobytes() == j[k].tobytes(), k
    assert pn == jn == 24
    assert prpc == jrpc
    assert prpc["READ"] == 24 and prpc.get("LOOKUP_DIR", 0) <= 1, prpc


def test_jax_sampler_state_runs_ahead_and_the_port_saves_the_train_step(agent):
    """The trap in the JAX Trainer's checkpoint (ROADMAP.md Queue 3): after
    5 batches are taken, JAX's pipeline (prefetch 2) has its sampler at
    step 7, which is what JAX's Trainer saves.  The port's Trainer, stopped
    after 5 steps, saves step 5, the next batch training takes."""
    lib = BLib(agent)
    JaxBuffetDataset.build(lib, _samples(n=64), name="c", shard_size=16)
    ds = JaxBuffetDataset(lib, name="c")
    sampler = JaxShardedSampler(n_samples=len(ds), global_batch=4, dp_rank=0, dp_size=1)
    pipe = JaxDataPipeline(ds, sampler, seq_len=16)
    it = iter(pipe)
    for _ in range(5):
        next(it)
    _settle(pipe, 5 + 2 + 1)   # 2 queued, 1 built and waiting for room
    assert sampler.state_dict() == {"step": 7, "seed": 0}
    pipe.stop()
    tr = Trainer(TrainerConfig(arch="mamba2-130m", steps=10, global_batch=4, seq_len=16,
                               ckpt_every=5, device="cpu"), lib=lib)
    tr.run(until=5)
    tr.shutdown()
    assert tr.ckpt.manifest(5).extra["sampler"] == {"step": 5, "seed": 0}


def test_hedged_read_beats_straggler(cluster4):
    """Port of tests/test_data_and_ckpt.py::test_hedged_read_beats_straggler."""
    cluster = cluster4
    agent = BAgent(cluster)
    lib = BLib(agent)
    ds = BuffetDataset.build(lib, _samples(n=32), name="hedged", shard_size=16,
                             replicate=True)
    sampler = ShardedSampler(n_samples=32, global_batch=4, dp_rank=0, dp_size=1)
    pipe = DataPipeline(ds, sampler, seq_len=16, hedge_delay_s=0.02, io_threads=4)
    shard_host = _host(agent, f"{ds.base}/shard_0000")
    with slow_server(cluster, shard_host, extra_delay_s=0.2):
        batch = next(iter(pipe))
    pipe.stop()
    agent.shutdown()
    assert batch["tokens"].shape == (4, 16)
    assert pipe.stats.hedged >= 1  # hedging actually fired


def test_hedged_read_survives_dead_server(cluster4):
    """Port of tests/test_data_and_ckpt.py::test_hedged_read_survives_dead_server:
    a dead primary BServer fails fast, and the read goes to the replica."""
    cluster = cluster4
    agent = BAgent(cluster)
    lib = BLib(agent)
    ds = BuffetDataset.build(lib, _samples(n=32), name="deadsrv", shard_size=16,
                             replicate=True)
    shard_host = _host(agent, f"{ds.base}/shard_0000")
    assert _host(agent, f"{ds.base}/replica_0000") != shard_host
    sampler = ShardedSampler(n_samples=32, global_batch=4, dp_rank=0, dp_size=1)
    pipe = DataPipeline(ds, sampler, seq_len=16, hedge_delay_s=0.05)
    with server_down(cluster, shard_host):
        batch = next(iter(pipe))
    pipe.stop()
    agent.shutdown()
    assert batch["tokens"].shape == (4, 16)
    assert pipe.stats.hedge_wins >= 1


# ---------------------------------------------------------------------------
# the Trainer over the pipeline
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases(agent):
    """Port of tests/test_runtime.py::test_trainer_loss_decreases: a
    learnable corpus written to BuffetFS and read through the pipeline;
    the first step's loss is the loss before any update."""
    tc = TrainerConfig(arch="stablelm-3b", steps=30, global_batch=4, seq_len=32,
                       lr=1e-3, ckpt_every=100, log_every=30, device="cpu")
    rng = np.random.default_rng(0)
    corpus = [np.tile(rng.integers(1, 64, size=8), 5).astype(np.uint32)
              for _ in range(64)]
    tr = Trainer(tc, lib=BLib(agent), corpus=corpus)
    tr.init_or_restore()
    out = tr.run()
    tr.shutdown()
    assert len(out["losses"]) == 30 and all(np.isfinite(out["losses"]))
    assert out["final_loss"] < out["losses"][0], out["losses"]
    assert tr.ckpt.steps() == [30]          # ckpt_every 100: the last step only
    assert tr.pipeline.stats.samples >= 30 * 4


def test_trainer_crash_restart_resumes(tmp_path):
    """Port of tests/test_runtime.py::test_trainer_crash_restart_resumes:
    the restarted Trainer, a new cluster over the same directory, resumes
    at step 10 with its sampler there, and runs the 2 steps left."""
    def trainer(steps):
        cluster = BuffetCluster(root_dir=str(tmp_path / "bfs"), n_servers=2)
        agent = BAgent(cluster)
        tc = TrainerConfig(arch="stablelm-3b", steps=steps, global_batch=4, seq_len=32,
                           ckpt_every=5, log_every=100, run_name="cr", device="cpu")
        return Trainer(tc, lib=BLib(agent)), agent, cluster

    tr, agent, cluster = trainer(10)
    tr.run()          # writes checkpoints at steps 5 and 10
    tr.shutdown()
    assert tr.ckpt.steps() == [5, 10]
    agent.shutdown()
    cluster.shutdown()

    tr2, agent, cluster = trainer(12)
    tr2.init_or_restore()
    assert tr2.start_step == 10
    assert tr2.sampler.step == tr2.sampler.state_dict()["step"] == 10
    out = tr2.run()   # only 2 more steps
    tr2.shutdown()
    extra = tr2.ckpt.manifest(12).extra
    agent.shutdown()
    cluster.shutdown()
    assert len(out["losses"]) == 2 and np.isfinite(out["final_loss"])
    assert extra == {"train_step": 12, "sampler": {"step": 12, "seed": 0},
                     "arch": tr2.cfg.name}


def test_trainer_warms_a_blib_and_reports_its_rpcs_not_dirlibs(agent, tmp_path,
                                                               monkeypatch):
    """Over a BLib the Trainer warms each shard directory through the agent
    (as JAX's) and reports the agent's RPC counts; over DirLib it reports
    none, rather than zeros."""
    warmed = []
    warm = agent.warm
    monkeypatch.setattr(agent, "warm", lambda path: (warmed.append(path), warm(path)))
    tc = TrainerConfig(arch="mamba2-130m", steps=2, global_batch=2, seq_len=16,
                       device="cpu", run_name="w")
    tr = Trainer(tc, lib=BLib(agent))
    out = tr.run()
    tr.shutdown()
    assert warmed == ["/corpus/train/shard_0000"]
    assert out["critical_rpcs"] > 0 and "async_rpcs" in out
    tr = Trainer(tc, lib=DirLib(str(tmp_path / "dir")))
    out = tr.run()
    tr.shutdown()
    assert "critical_rpcs" not in out and "async_rpcs" not in out
    assert tr.ckpt.steps() == [2] and len(tr.dataset) == 128


def test_trainer_with_batches_writes_no_checkpoint(tmp_path):
    """`batches=` keeps the Trainer's old path: no dataset, no checkpoint, no
    storage at all, whatever data_dir says."""
    toks = np.random.default_rng(4).integers(1, 512, (2, 17)).astype(np.int32)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, 16), np.float32)}
    tc = TrainerConfig(arch="mamba2-130m", steps=2, global_batch=2, seq_len=16,
                       ckpt_every=1, device="cpu", data_dir=str(tmp_path / "d"))
    tr = Trainer(tc, batches=[fixed, fixed])
    out = tr.run()
    assert tr.lib is tr.ckpt is tr.pipeline is None and len(out["losses"]) == 2
    assert not (tmp_path / "d").exists()


# ---------------------------------------------------------------------------
# the port's Trainer: stopped and resumed is uninterrupted, bit for bit
# ---------------------------------------------------------------------------

def _recorded(tr):
    """The Trainer with every batch it takes recorded."""
    seen, to_device = [], tr._to_device
    tr._to_device = lambda b: (seen.append({k: np.array(v) for k, v in b.items()}),
                               to_device(b))[1]
    return tr, seen


def test_resume_after_a_stop_is_bitwise_the_uninterrupted_run(tmp_path):
    """mamba2-130m (reduced): 4 steps, stopped (a checkpoint at 4), then a
    new Trainer over the same directory resumes and runs 4 more; its
    batches, losses and final state are those of 8 steps uninterrupted."""
    def tc(run):
        return TrainerConfig(arch="mamba2-130m", steps=8, global_batch=2, seq_len=32,
                             ckpt_every=4, log_every=100, run_name=run, device="cpu",
                             data_dir=str(tmp_path))
    a, a_seen = _recorded(Trainer(tc("r")))
    out_a = a.run(until=4)
    a.shutdown()
    assert a.ckpt.steps() == [4] and len(out_a["losses"]) == 4
    b, b_seen = _recorded(Trainer(tc("r")))
    b.init_or_restore()
    assert b.start_step == 4
    for x, y in zip(tree_leaves(b.state), tree_leaves(a.state)):
        assert torch.equal(x.detach(), y.detach())
    out_b = b.run()
    b.shutdown()
    c, c_seen = _recorded(Trainer(tc("whole")))
    out_c = c.run()
    c.shutdown()
    assert b.ckpt.steps() == c.ckpt.steps() == [4, 8]
    for x, y in zip(a_seen + b_seen, c_seen):
        assert all(x[k].tobytes() == y[k].tobytes() for k in y)
    assert len(c_seen) == 8
    assert out_a["losses"] + out_b["losses"] == out_c["losses"]
    for x, y in zip(tree_leaves(b.state), tree_leaves(c.state)):
        assert torch.equal(x.detach(), y.detach())

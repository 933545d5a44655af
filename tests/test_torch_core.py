"""The port's BuffetFS clusters against the JAX package's, on the CPU.

One scripted flow runs on a cluster of each package, each in its own
directory over the in-process transport, for replicas in {1, 2} and
stripe_count in {1, 2}: makedirs, bulk writes and reads, a chmod by the
owner that invalidates a second agent's cached permission (paper §3.4),
rename, truncate, a write and fsync of a striped file, its unlink, and
accesses the permissions refuse.  Both give the same results and errnos,
the same RPC counts (`RpcStats.snapshot()` of each agent after `drain()`,
all but the serialization times), and the same bytes on disk: every
server's object files, and its `meta.json` with the times masked.  A
cluster directory written by one package restarts in the other.  The
Lustre baselines cost the same RPCs in both; a flow over real sockets
sends and receives the same bytes; a hedged read survives a dead server on
the port's cluster.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as jax_core
import repro_torch.core as port_core

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_core, "port": port_core}
STRIPE = 4096


class _FixedWallClock:
    """The `time` module with a fixed wall clock: a server stamps atime,
    mtime and ctime from `time.time()`, and a STAT reply carries them as
    JSON floats whose length varies with the value, so the bytes a flow
    receives depend on when it ran unless the clock is fixed."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return 1_700_000_000.5


@pytest.fixture()
def fixed_wall_clock(monkeypatch):
    for P in PACKAGES.values():
        monkeypatch.setattr(importlib.import_module(f"{P.__name__}.bserver"), "time",
                            _FixedWallClock())


def _snapshot(stats):
    snap = stats.snapshot()
    return {k: v for k, v in snap.items() if not k.endswith("_ns")}


def _flow(P, root, replicas=1, stripe_count=1, transport=None):
    """The scripted flow on a fresh 4-server cluster of package `P` in
    `root`: (results, [owner's snapshot, reader's snapshot])."""
    kw = {} if transport is None else {"transport": transport}
    c = P.BuffetCluster(root_dir=str(root), n_servers=4, replicas=replicas,
                        stripe_count=stripe_count, stripe_size=STRIPE, **kw)
    owner = P.BAgent(c, cred=P.Credentials(uid=0), client_id="owner")
    reader = P.BAgent(c, cred=P.Credentials(uid=1000, gid=1000), client_id="reader")
    ol, rl = P.BLib(owner), P.BLib(reader)
    rng = np.random.default_rng(0)
    out = {}

    def errno_of(fn):
        try:
            fn()
        except OSError as e:
            return e.errno
        return 0
    try:
        ol.makedirs("/a/b")
        ol.makedirs("/c")
        paths = [f"/a/b/f{i}" for i in range(6)]
        blobs = [rng.bytes(n) for n in (10, 100, 5000, 9000, STRIPE, 1)]
        out["written"] = ol.write_files(paths, blobs)
        big = rng.bytes(3 * STRIPE + 17)
        ol.write_file("/c/big", big)
        out["read_files"] = ol.read_files(paths) == blobs
        out["layout"] = ol.layout("/c/big")
        reader.warm("/a/b")
        out["reader_read"] = rl.read_file(paths[0]) == blobs[0]
        ol.chmod(paths[0], 0o600)            # invalidates the reader's /a/b first
        out["denied_after_chmod"] = errno_of(lambda: rl.read_file(paths[0]))
        ol.rename(paths[1], "g1")
        out["listdir"] = ol.listdir("/a/b")
        out["renamed"] = rl.read_file("/a/b/g1") == blobs[1]
        with ol.open(paths[3], "r+b") as f:
            f.write(b"xyz")
        out["overwritten"] = ol.read_file(paths[3]) == b"xyz" + blobs[3][3:]
        ol.write_file(paths[2], b"short")    # open(O_TRUNC): a truncate
        out["truncated"] = ol.read_file(paths[2])
        with ol.open("/c/big", "r+b") as f:
            f.write(b"Q" * 5000)
            f.fsync()
        out["striped"] = rl.read_file("/c/big") == b"Q" * 5000 + big[5000:]
        out["stat_size"] = ol.stat("/c/big")["size"]
        ol.unlink("/c/big")
        out["unlinked"] = (ol.exists("/c/big"),
                           errno_of(lambda: rl.read_file("/c/big")))
        ol.chmod(paths[4], 0o444)
        out["denied_write"] = errno_of(lambda: rl.open(paths[4], "r+b"))
        out["missing"] = errno_of(lambda: rl.read_file("/a/b/nope"))
        out["async_errors"] = (owner.drain(), reader.drain())
        snaps = [_snapshot(owner.stats), _snapshot(reader.stats)]
    finally:
        owner.shutdown()
        reader.shutdown()
        c.shutdown()
    return out, snaps


def _mask_times(obj):
    if isinstance(obj, dict):
        return {k: ("<time>" if k.endswith("time") else _mask_times(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_times(v) for v in obj]
    return obj


def _disk(root):
    """Every server's object files (name: bytes) and its meta.json, times
    masked."""
    out = {}
    for srv in sorted(Path(root).glob("bserver*")):
        objs = {p.name: p.read_bytes() for p in sorted((srv / "objs").iterdir())}
        out[srv.name] = (objs, _mask_times(json.loads((srv / "meta.json").read_text())))
    return out


@pytest.mark.parametrize("stripe_count", [1, 2])
@pytest.mark.parametrize("replicas", [1, 2])
def test_scripted_flow_matches_jax(tmp_path, fixed_wall_clock, replicas, stripe_count):
    got = {name: _flow(P, tmp_path / name, replicas, stripe_count)
           for name, P in PACKAGES.items()}
    (jout, jsnaps), (pout, psnaps) = got["jax"], got["port"]
    assert pout == jout
    assert pout["denied_after_chmod"] == pout["denied_write"] == 13     # EACCES
    assert pout["unlinked"] == (False, 2) and pout["missing"] == 2      # ENOENT
    assert pout["async_errors"] == (0, 0) and pout["truncated"] == b"short"
    assert all(v is True for k, v in pout.items()
               if k in ("read_files", "reader_read", "renamed", "overwritten", "striped"))
    assert (pout["layout"] is not None) == (stripe_count > 1)
    assert psnaps == jsnaps
    assert psnaps[0]["by_type"].get("OPEN_RECORD", 0) == 0
    jdisk, pdisk = _disk(tmp_path / "jax"), _disk(tmp_path / "port")
    assert sorted(pdisk) == ["bserver0", "bserver1", "bserver2", "bserver3"]
    assert {s: sorted(d[0]) for s, d in pdisk.items()} == \
        {s: sorted(d[0]) for s, d in jdisk.items()}
    assert pdisk == jdisk
    assert sum(len(d[0]) for d in pdisk.values()) >= 6


def _write_tree(P, root, stripe_count):
    c = P.BuffetCluster(root_dir=str(root), n_servers=4, stripe_count=stripe_count,
                        stripe_size=STRIPE)
    a = P.BAgent(c)
    lib = P.BLib(a)
    rng = np.random.default_rng(11)
    files = {f"/d{i % 3}/s{i}/f{i}": rng.bytes(int(n))
             for i, n in enumerate(rng.integers(1, 3 * STRIPE, size=12))}
    for p, blob in files.items():
        lib.makedirs(p.rsplit("/", 1)[0])
        lib.write_file(p, blob)
    a.shutdown()
    c.shutdown()
    return files


def _read_tree(P, root, stripe_count, files, add=None):
    c = P.BuffetCluster(root_dir=str(root), n_servers=4, stripe_count=stripe_count,
                        stripe_size=STRIPE)
    a = P.BAgent(c)
    lib = P.BLib(a)
    try:
        got = {p: lib.read_file(p) for p in files}
        walked = sorted(lib.walk_files("/"))
        if add is not None:
            lib.write_file(add[0], add[1])
            lib.unlink(next(iter(files)))
    finally:
        a.shutdown()
        c.shutdown()
    return got, walked


@pytest.mark.parametrize("stripe_count", [1, 2])
@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_a_cluster_directory_restarts_in_the_other_package(tmp_path, first, then,
                                                           stripe_count):
    """Written and shut down by one package, the servers restart in the
    other from their persisted meta.json and objects: every file reads
    back; a file it writes and one it unlinks are seen by the first again."""
    files = _write_tree(PACKAGES[first], tmp_path, stripe_count)
    got, walked = _read_tree(PACKAGES[then], tmp_path, stripe_count, files,
                             add=("/d0/new", b"from the other package"))
    assert got == files and walked == sorted(files)
    rest = dict(files)
    rest.pop(next(iter(files)))
    rest["/d0/new"] = b"from the other package"
    got, walked = _read_tree(PACKAGES[first], tmp_path, stripe_count, rest)
    assert got == rest and walked == sorted(rest)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("system", ["lustre-normal", "lustre-dom"])
def test_lustre_baselines_cost_the_same_rpcs(tmp_path, system):
    """N files made by the baseline path (JAX: `benchmarks/common.py::
    mkfiles`; the port: `chip_smoke.lustre_mkfiles`, its copy), then
    opened, read and closed by a fresh client of each package: the same
    count of every verb, per file."""
    from benchmarks.common import mkfiles
    cs = _chip_smoke()
    n, size, dirs = 24, 8208, 3
    cls = "LustreDoMClient" if system == "lustre-dom" else "LustreNormalClient"
    blob = b"x" * size
    jc = jax_core.BuffetCluster(root_dir=str(tmp_path / "jax"), n_servers=4)
    pc = port_core.BuffetCluster(root_dir=str(tmp_path / "port"), n_servers=4)
    try:
        jpaths = mkfiles(jc, n, size, n_dirs=dirs, prefix="/corpus", system=system)
        maker = getattr(port_core, cls)(pc)
        ppaths = cs.lustre_mkfiles(port_core, maker, [blob] * n, dirs)
        maker.shutdown()
        assert ppaths == jpaths
        jclient, pclient = getattr(jax_core, cls)(jc), getattr(port_core, cls)(pc)
        jrec = cs.open_read_close(jclient, jpaths, [blob] * n)
        prec = cs.open_read_close(pclient, ppaths, [blob] * n)
        jclient.shutdown()
        pclient.shutdown()
    finally:
        jc.shutdown()
        pc.shutdown()
    for r in (jrec, prec):
        r.pop("host_wall_us_per_file")
    assert prec == jrec and prec["bad_reads"] == 0
    verb = "READ_INLINE" if system == "lustre-dom" else "OPEN_RECORD"
    assert prec["by_type_per_file"][verb] == 1.0
    # a fresh client's dentry cache misses twice: the root's listing names
    # /corpus, whose listing names every directory
    assert prec["by_type_per_file"]["LOOKUP_DIR"] == 2 / n


def test_flow_over_tcp_sends_and_receives_the_same_bytes(tmp_path, fixed_wall_clock):
    """The flow over each package's TCPTransport (real sockets on
    127.0.0.1): the same results and byte counts; the hosts' addresses
    (their ports) are all that differs."""
    got = {name: _flow(P, tmp_path / name, transport=P.TCPTransport())
           for name, P in PACKAGES.items()}
    (jout, jsnaps), (pout, psnaps) = got["jax"], got["port"]
    assert pout == jout
    for j, p in zip(jsnaps, psnaps):
        assert sorted(p.pop("by_host").values()) == sorted(j.pop("by_host").values())
        assert p == j and p["bytes_sent"] > 0 and p["bytes_recv"] > 0


def test_hedged_read_survives_dead_server_on_the_ports_cluster(tmp_path):
    """Port of tests/test_data_and_ckpt.py::test_hedged_read_survives_dead_server
    on the port's own cluster: a dead primary BServer fails fast, and the
    read goes to the replica."""
    from repro_torch.core.failure import server_down
    from repro_torch.core.inode import Inode
    from repro_torch.data import BuffetDataset, DataPipeline, ShardedSampler
    c = port_core.BuffetCluster(root_dir=str(tmp_path), n_servers=4)
    agent = port_core.BAgent(c)
    lib = port_core.BLib(agent)
    rng = np.random.default_rng(0)
    samples = [rng.integers(1, 1000, size=24).astype(np.uint16) for _ in range(32)]
    ds = BuffetDataset.build(lib, samples, name="deadsrv", shard_size=16, replicate=True)
    host = Inode.unpack(agent.stat_cached(f"{ds.base}/shard_0000")["ino"]).host_id
    assert Inode.unpack(agent.stat_cached(f"{ds.base}/replica_0000")["ino"]).host_id != host
    sampler = ShardedSampler(n_samples=32, global_batch=4, dp_rank=0, dp_size=1)
    pipe = DataPipeline(ds, sampler, seq_len=16, hedge_delay_s=0.05)
    try:
        with server_down(c, host):
            batch = next(iter(pipe))
    finally:
        pipe.stop()
        agent.shutdown()
        c.shutdown()
    assert batch["tokens"].shape == (4, 16)
    assert pipe.stats.hedge_wins >= 1


@pytest.mark.parametrize("name", ["server_down", "slow_server", "delayed", "partitioned",
                                  "crash_restart_cycle"])
def test_failure_helpers_are_the_ports_own(name):
    """Each failure helper of the port drives the port's cluster: the same
    names as the JAX package's, defined in the port's module."""
    fn = getattr(importlib.import_module("repro_torch.core.failure"), name)
    ref = getattr(importlib.import_module("repro.core.failure"), name)
    assert fn.__module__ == "repro_torch.core.failure" and fn.__doc__ == ref.__doc__

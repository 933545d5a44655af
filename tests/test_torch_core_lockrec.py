"""`repro_torch.core.analysis.lockrec.LockOrderRecorder` on the port's
BuffetFS, held to `repro.core.analysis.lockrec` on JAX's.

The workload of `tests/test_lock_order_runtime.py` (copied: namespace
churn, striped I/O with the O_TRUNC clip, fsync, ACLs, groups, rename,
unlink, scrub) runs once on a port cluster whose servers the port's
recorder instruments and once on a JAX cluster under JAX's recorder (4
servers, stripe count 4, stripe size 64 KiB).  Both record exactly the
same six nestings, none against the declared order, every class
registered; with the ranks inverted by hand the recorder reports all six.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import pytest

import repro.core as jax_core
import repro.core.analysis as jax_analysis
import repro_torch.core as port_core
import repro_torch.core.analysis as port_analysis
from repro_torch.core.analysis.buffetlint import LOCK_RANK

SS = 64 * 1024
SIX = {("chunk_lock", "server_lock"), ("dir_mutex", "chunk_lock"),
       ("dir_mutex", "server_lock"), ("file_lock", "chunk_lock"),
       ("file_lock", "server_lock"), ("groups_mutex", "server_lock")}


def _workload(core, cluster):
    """Namespace churn + striped I/O + permissions — the lock-heavy
    paths: dir mutexes, per-file serialization, chunk fan-out on the
    stripe hosts, the group-table mutex, and the scrubber."""
    lib = core.BLib(core.BAgent(cluster))
    lib.makedirs("/a/b")
    data = bytes(i % 251 for i in range(3 * SS + 17))  # crosses stripes
    lib.write_file("/a/b/striped", data)
    assert lib.read_file("/a/b/striped") == data
    lib.write_file("/a/b/striped", data[:SS])          # O_TRUNC clip path
    with lib.open("/a/b/synced", "wb") as f:
        f.write(b"durable")
        f.fsync()
    lib.setacl("/a/b/striped", [["u", 7, 4, 0]])
    lib.setgroups(7, [500])
    lib.rename("/a/b/striped", "renamed")
    lib.unlink("/a/b/renamed")
    lib.scrub()
    lib.agent.drain()
    lib.agent.shutdown()


@pytest.fixture(scope="module")
def recorders(tmp_path_factory):
    """Each package's recorder after the workload on its own cluster."""
    out = {}
    for name, core, analysis in (("port", port_core, port_analysis),
                                 ("jax", jax_core, jax_analysis)):
        c = core.BuffetCluster(root_dir=str(tmp_path_factory.mktemp(name)), n_servers=4,
                               stripe_count=4, stripe_size=SS)
        rec = analysis.LockOrderRecorder()
        try:
            for srv in c.servers.values():
                rec.instrument_server(srv)
            _workload(core, c)
        finally:
            c.shutdown()
        out[name] = rec
    return out


@pytest.mark.parametrize("name", ["port", "jax"])
def test_workload_records_the_six_nestings_in_order(recorders, name):
    rec = recorders[name]
    assert rec.pairs == SIX
    assert rec.violations() == []


def test_port_and_jax_record_the_same_nestings(recorders):
    assert recorders["port"].pairs == recorders["jax"].pairs


def test_every_observed_class_is_registered(recorders):
    for held, acquired in recorders["port"].pairs:
        assert held in LOCK_RANK and acquired in LOCK_RANK


def test_inverted_ranks_report_every_nesting(recorders):
    inverted = {k: -v for k, v in LOCK_RANK.items()}
    assert recorders["port"].violations(inverted) == sorted(SIX)
    assert recorders["jax"].violations(inverted) == sorted(SIX)


def test_recorder_is_the_port_own():
    assert port_analysis.LockOrderRecorder is not jax_analysis.LockOrderRecorder
    assert port_analysis.lockrec.LOCK_RANK is LOCK_RANK

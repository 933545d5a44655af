"""Failure injection & recovery scenarios over a BuffetCluster.

Exercised by tests, the failover example and the fig11 benchmark: the
paper's §3.2 version segment exists precisely to make server restarts
detectable by clients; this module packages the kill/restart/slow/partition
scenarios used for fault-tolerance validation and straggler-mitigation
benchmarks.

All injectors are TRANSPORT-GENERIC: they go through
``Transport.wrap_handler`` (implemented by both the in-proc registry and
the TCP server), so the same test body runs over either wire.  Any served
address can be targeted — a BServer, or a client agent's callback endpoint
(partitioning a callback address is how the lease-TTL wait-out path is
exercised: REVOKE_LEASE fails, the server must sleep out the grant instead
of force-breaking it).
"""
from __future__ import annotations

import contextlib
import errno
import time
from typing import Iterator

from .cluster import BuffetCluster
from .transport import Addr, Transport
from .wire import error


@contextlib.contextmanager
def server_down(cluster: BuffetCluster, host_id: int) -> Iterator[None]:
    """Take a server down for the duration of the context; restart (with a
    version bump) on exit."""
    cluster.kill_server(host_id)
    try:
        yield
    finally:
        cluster.restart_server(host_id)


@contextlib.contextmanager
def delayed(transport: Transport, addr: Addr,
            extra_delay_s: float = 0.05) -> Iterator[None]:
    """Delay every frame delivered to `addr` by `extra_delay_s` — a
    straggling server, a congested callback path — on any transport."""
    def wrap(orig):
        def slow(msg):
            time.sleep(extra_delay_s)
            return orig(msg)
        return slow

    restore = transport.wrap_handler(addr, wrap)
    try:
        yield
    finally:
        restore()


@contextlib.contextmanager
def slow_server(cluster: BuffetCluster, host_id: int,
                extra_delay_s: float = 0.05) -> Iterator[None]:
    """Make one server a straggler by wrapping its handler with a delay."""
    with delayed(cluster.transport, cluster.config.addr(host_id),
                 extra_delay_s):
        yield


@contextlib.contextmanager
def partitioned(transport: Transport, addr: Addr,
                fail_errno: int = errno.ENOTCONN) -> Iterator[None]:
    """Cut `addr` off the network: every frame fails with `fail_errno`
    (ENOTCONN by default — indistinguishable from a dead host to the
    caller) while the peer itself keeps running, state intact.  Heals on
    exit.  This is a PARTITION, not a crash: the incarnation does not
    change, so a healed peer resumes without any ESTALE recovery."""
    def wrap(orig):
        del orig  # frames are dropped, not delivered

        def drop(msg):
            return error(fail_errno, f"{addr!r} partitioned (injected)")
        return drop

    restore = transport.wrap_handler(addr, wrap)
    try:
        yield
    finally:
        restore()


def crash_restart_cycle(cluster: BuffetCluster, host_id: int,
                        *, crash: bool = True) -> int:
    """One full crash/restart cycle; returns the new incarnation version."""
    cluster.kill_server(host_id)
    return cluster.restart_server(host_id, crash=crash)

"""Decentralized BuffetFS cluster — no metadata server anywhere (paper §3.2).

`ClusterConfig` is the client-local configuration file the paper describes:
it maps a `(hostID, version)` tuple to a server address, so a bare inode
number is enough to locate any file in the cluster.

`BuffetCluster` owns the server processes for tests/benchmarks and provides
the placement policy: the namespace is partitioned at *directory*
granularity (each directory object, with its dentries + child permission
records, lives on the host chosen by a stable hash of its path), and a
file's data lives on the host of its parent directory by default — this is
how BuffetFS "only needs to manage servers that store files and directories
data" with no MDS.

Optional replication (`replicas=2`) lets the data pipeline issue hedged
reads for straggler mitigation.
"""
from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .bserver import BServer
from .transport import InProcTransport, LatencyModel, Transport
from .wire import Message, MsgType


def stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2s(s.encode(), digest_size=8).digest(), "little")


@dataclass
class HostEntry:
    addr: str
    version: int


class ClusterConfig:
    """Client-side (hostID, version) -> address map; thread-safe."""

    def __init__(self, hosts: Optional[Dict[int, HostEntry]] = None) -> None:
        self._hosts: Dict[int, HostEntry] = dict(hosts or {})
        self._lock = threading.Lock()

    def addr(self, host_id: int) -> str:
        with self._lock:
            return self._hosts[host_id].addr

    def version(self, host_id: int) -> int:
        with self._lock:
            return self._hosts[host_id].version

    def hosts(self) -> List[int]:
        with self._lock:
            return sorted(self._hosts)

    def set(self, host_id: int, addr: str, version: int) -> None:
        with self._lock:
            self._hosts[host_id] = HostEntry(addr, version)

    def bump_version(self, host_id: int, version: int) -> None:
        with self._lock:
            self._hosts[host_id].version = version

    def copy(self) -> "ClusterConfig":
        with self._lock:
            return ClusterConfig({k: HostEntry(v.addr, v.version)
                                  for k, v in self._hosts.items()})


@dataclass
class BuffetCluster:
    """A sandbox BuffetFS cluster: N BServers over one transport."""

    root_dir: str
    n_servers: int = 4
    transport: Transport = None  # type: ignore[assignment]
    latency: Optional[LatencyModel] = None
    # chunk replication factor: striped files place every chunk on
    # `replicas` hosts (primary + the next r-1 clockwise on the layout
    # ring), the scatter path requires a write quorum, reads hedge/fail
    # over between copies, and the scrubber re-replicates missing copies.
    # replicas=1 (default) keeps the original single-copy placement and
    # byte-identical RPC behavior; replicas=2 is the recommended
    # durability setting.
    replicas: int = 1
    fsync_policy: str = "none"
    # data-plane striping policy: files created while stripe_count > 1 get
    # a stripe layout (stripe_size + ordered host list) allocated at
    # CREATE time and carried in the dentry.  stripe_count=1 (default)
    # keeps the original whole-file-on-home-host placement, so existing
    # workloads and the paper's small-file RPC counts are untouched.
    stripe_size: int = 1 << 20
    stripe_count: int = 1
    # periodic background scrub on every server (seconds between passes);
    # None leaves reconciliation on-demand only (the SCRUB verb /
    # BLib.scrub()) so tests and benchmarks stay deterministic by default
    scrub_interval: Optional[float] = None
    # home-host failover: when True every server ships its commit log
    # (metadata mutations + home-resident object writes) to its standby —
    # replica_host(host_id) — and a dead home can be promote()d there.
    replication: bool = False
    # read-lease TTL handed to every server: clients stop serving cached
    # blocks at expiry, servers wait out unacked revokes instead of
    # force-breaking, and a promoted standby fences its first mutation
    # behind one TTL
    lease_ttl_s: float = 5.0
    # heartbeat failure detection: when set, every server probes its peers
    # with HEARTBEAT frames on a background thread at this period, and the
    # cluster (with auto_promote=True) runs a monitor that declares a host
    # dead — and drives the existing promote() — only after
    # heartbeat_misses consecutive missed beats AND a quorum of observers
    # (n//2 + 1, counting the monitor itself) agreeing the host is gone.
    # The quorum is what makes a partitioned observer safe: cut off from
    # the majority it can gather at most a minority of votes, so it never
    # promotes a healthy host it merely cannot see.
    heartbeat_interval_s: Optional[float] = None
    auto_promote: bool = False
    heartbeat_misses: int = 3
    servers: Dict[int, BServer] = field(default_factory=dict)
    config: ClusterConfig = field(default_factory=ClusterConfig)
    root_ino: int = 0
    # monitor observability: promotions the monitor drove, promotions it
    # attempted that raised, and dead-host declarations vetoed by quorum
    auto_promotes: int = 0
    auto_promote_failures: int = 0
    quorum_vetoes: int = 0

    def __post_init__(self) -> None:
        if self.transport is None:
            self.transport = InProcTransport(self.latency)
        from .transport import TCPTransport
        tcp = isinstance(self.transport, TCPTransport)
        for host_id in range(self.n_servers):
            backing = os.path.join(self.root_dir, f"bserver{host_id}")
            os.makedirs(backing, exist_ok=True)
            addr = "127.0.0.1:0" if tcp else f"bserver:{host_id}"
            srv = BServer(host_id, backing, self.transport, addr,
                          fsync_policy=self.fsync_policy,
                          scrub_interval=self.scrub_interval,
                          lease_ttl_s=self.lease_ttl_s)
            self.servers[host_id] = srv
            self.config.set(host_id, srv.addr, srv.version)
        # every server holds the same "local configuration file" clients
        # hold (paper §3.2): the home host needs it to reach stripe hosts
        # when it orchestrates truncate/unlink/fsync over chunk objects
        for srv in self.servers.values():
            srv.peers = self.config
        # replication starts BEFORE make_root so the log covers the
        # namespace from genesis (the seed snapshot is empty) — but after
        # peers are wired, since the shipper routes through them
        if self.replication and self.n_servers > 1:
            for host_id, srv in self.servers.items():
                srv.start_replication(self.replica_host(host_id))
        self.root_ino = self.servers[0].make_root().pack()
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if self.heartbeat_interval_s is not None and self.n_servers > 1:
            for srv in self.servers.values():
                srv.start_heartbeats(self.heartbeat_interval_s)
            if self.auto_promote:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="hb-monitor", daemon=True)
                self._monitor.start()

    # --- placement -----------------------------------------------------
    def place_dir(self, path: str) -> int:
        """Directory-granularity namespace partitioning."""
        if path in ("", "/"):
            return 0
        return stable_hash(path) % self.n_servers

    def place_stripes(self, path: str, home: int) -> Optional[Dict]:
        """Stripe layout for a new file: `stripe_size` plus an ordered host
        list.  hosts[0] is always the file's HOME host — the host the
        dentry's inode points at, which keeps FileMeta and the lease table
        — so a file no larger than one stripe still costs exactly one
        critical-path RPC to read (the home READ serves stripe 0 inline).
        The remaining hosts rotate from a stable hash of the path, so a
        directory of large files spreads its chunk load across the whole
        cluster.  None => striping disabled (or nowhere to stripe to)."""
        k = min(self.stripe_count, self.n_servers)
        if k <= 1:
            return None
        hosts = [home]
        start = stable_hash(path)
        for i in range(self.n_servers):
            if len(hosts) == k:
                break
            h = (start + i) % self.n_servers
            if h != home:
                hosts.append(h)
        layout = {"ss": self.stripe_size, "hosts": hosts}
        # replication factor rides in the layout record itself (chunk i's
        # replica j lives on hosts[(i + j) % k] — a rotation offset on the
        # same path-hash ring), so every party that can read the dentry
        # knows the full replica set with zero extra RPCs.  Omitted at
        # r=1: layouts without replicas stay byte-identical.
        r = min(self.replicas, len(hosts))
        if r > 1:
            layout["r"] = r
        return layout

    def replica_host(self, host_id: int, k: int = 1) -> int:
        return (host_id + k) % self.n_servers

    # --- failure injection ----------------------------------------------
    def kill_server(self, host_id: int) -> None:
        self.servers[host_id].shutdown()

    def restart_server(self, host_id: int, *, crash: bool = False) -> int:
        """Restart a server; its incarnation version increments (paper §3.2).
        Returns the new version.  The cluster config (the 'local configuration
        file' every client holds) is updated out-of-band, as an admin would
        push it."""
        srv = self.servers[host_id]
        srv.restart(crash=crash)
        self.config.bump_version(host_id, srv.version)
        return srv.version

    def promote(self, dead_host_id: int,
                standby_id: Optional[int] = None) -> int:
        """Promote the standby's replica of a dead home into the new
        serving authority for that host id.  The standby materializes its
        replica, boots a fresh BServer under the dead identity with a
        bumped incarnation (fenced behind one lease TTL for its first
        mutation), and this method re-points the cluster config — exactly
        the out-of-band push an admin's failover runbook would do.
        Clients recover through their ordinary ESTALE/refused retry path.
        Returns the promoted incarnation's version."""
        if standby_id is None:
            standby_id = self.replica_host(dead_host_id)
        standby = self.servers[standby_id]
        srv = standby.promote_peer(dead_host_id)
        self.servers[dead_host_id] = srv
        self.config.set(dead_host_id, srv.addr, srv.version)
        # the promoted instance lives on the standby's machine, so its own
        # commit log ships one host further along the ring — never to the
        # machine it already lives on
        if self.replication and self.n_servers > 2:
            target = self.replica_host(dead_host_id)
            if target == standby_id:
                target = self.replica_host(dead_host_id, 2)
            srv.start_replication(target)
        if self.heartbeat_interval_s is not None and self.n_servers > 1:
            srv.start_heartbeats(self.heartbeat_interval_s)
        return srv.version

    # --- heartbeat monitor (auto-promote) --------------------------------
    def _hb_request(self, host_id: int, header: Optional[Dict] = None
                    ) -> Optional[Dict]:
        """One HEARTBEAT round trip to `host_id`; None if unreachable."""
        try:
            resp = self.transport.request(
                self.config.addr(host_id),
                Message(MsgType.HEARTBEAT, dict(header or {})))
        except OSError:
            return None
        if resp.type is MsgType.ERROR:
            return None
        return resp.header

    def _monitor_loop(self) -> None:
        """Declare hosts dead and drive promote() — with a quorum check.

        A host D is promoted only when (a) the monitor's own probes have
        missed `heartbeat_misses` beats in a row AND (b) at least
        n//2 + 1 observers — the monitor plus peers whose HEARTBEAT view
        reports D unseen for >= misses*interval — agree.  A monitor on
        the wrong side of a partition fails (b): the peers it can still
        reach keep seeing D, so the vote stays in the minority and the
        healthy host is never usurped."""
        interval = float(self.heartbeat_interval_s or 1.0)
        stale_after = self.heartbeat_misses * interval
        quorum = self.n_servers // 2 + 1
        misses: Dict[int, int] = {}
        while not self._monitor_stop.wait(interval):
            for host_id in self.config.hosts():
                if self._hb_request(host_id) is not None:
                    misses[host_id] = 0
                    continue
                misses[host_id] = misses.get(host_id, 0) + 1
                if misses[host_id] < self.heartbeat_misses:
                    continue
                votes = 1  # the monitor itself
                for peer in self.config.hosts():
                    if peer == host_id:
                        continue
                    view = self._hb_request(peer, {"view": True})
                    if view is None:
                        continue
                    age = view.get("hb_seen", {}).get(str(host_id))
                    if age is not None and age >= stale_after:
                        votes += 1
                if votes < quorum:
                    self.quorum_vetoes += 1
                    continue
                try:
                    self.promote(host_id)
                    self.auto_promotes += 1
                    misses[host_id] = 0
                except Exception:
                    # promotion is retried on the next tick; a standby
                    # that cannot promote (no replication) must not kill
                    # the monitor thread
                    self.auto_promote_failures += 1

    def stop_monitor(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None

    def ping(self, host_id: int) -> Dict:
        resp = self.transport.request(self.config.addr(host_id),
                                      Message(MsgType.PING))
        return resp.header

    def refresh_host(self, host_id: int) -> int:
        """Client-side recovery: re-learn a server's incarnation via PING."""
        info = self.ping(host_id)
        if "version" in info:
            self.config.bump_version(host_id, info["version"])
            return info["version"]
        raise ConnectionError(f"host {host_id} unreachable")

    def shutdown(self) -> None:
        self.stop_monitor()
        for srv in self.servers.values():
            srv.shutdown()

    # --- convenience ------------------------------------------------------
    def total_opened(self) -> int:
        return sum(s.opened_count() for s in self.servers.values())

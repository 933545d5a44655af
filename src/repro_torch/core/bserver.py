"""BServer — the BuffetFS storage server (paper §3.1, §3.2, §3.4).

A BServer owns a shard of the decentralized namespace: the directories whose
dentries (name, inode, 10-byte permission record) it stores, and the file
objects whose data lives in its ext4-backed object store.  There is no
metadata server anywhere — any BServer answers LOOKUP_DIR for directories it
owns, and clients assemble the global namespace from `(hostID, version)`
routing (see `repro_torch.core.cluster`).

Responsibilities faithful to the paper:
  * directory data = dentries + child permission records  (§3.2)
  * opened-file list, updated by the *deferred* step-2 of open() that arrives
    piggybacked on the first READ/WRITE (`incomplete_open`)  (§3.3)
  * per-directory client registry + blocking invalidation fan-out before any
    permission change is applied  (§3.4 strong consistency)
  * per-file server-side locks for concurrent modification ("BuffetFS
    arranges file locks inside the BServer", §4)
  * version number bumped on restart/restore  (§3.2)

Dispatch goes through the explicit operation registry in
`repro_torch.core.service` (SERVER_OPS): every verb — including the Lustre
baseline verbs OPEN_RECORD/READ_INLINE, which register from
`repro_torch.core.baselines` — is declared there, and the BATCH envelope is
executed generically on top, so all three systems in the paper's evaluation
run against identical storage and the same batching machinery.
"""
from __future__ import annotations

import errno
import json
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .inode import Inode, ROOT_FILE_ID
from .perms import (FSError, PermRecord, S_IFDIR, S_IFREG, normalize_groups,
                    validate_acl)
from .repl import ReplicaStore, ReplicationLog
from .service import MAX_TREE_DEPTH, SERVER_OPS
from .transport import Transport
from .wire import (EPOCHSTALE, Message, MsgType, chunk_hosts, error, ok,
                   stripe_spans)


@dataclass
class FileMeta:
    perm: PermRecord
    size: int = 0
    is_dir: bool = False
    nlink: int = 1
    atime: float = 0.0
    mtime: float = 0.0
    ctime: float = 0.0
    xattrs: Dict[str, str] = field(default_factory=dict)  # front-end metadata mirror
    # per-file mutation sequence, bumped under the file lock by every
    # WRITE/TRUNCATE and echoed in READ/WRITE/TRUNCATE responses: clients
    # order their cache fills/patches by it, so two acks processed out of
    # order can never regress the cache.  Volatile on purpose (not
    # persisted): a restart resets it together with the lease table, and
    # clients key their stamps by (incarnation, wseq).
    wseq: int = 0
    # stripe layout ({"ss": stripe_size, "hosts": [...]}) for striped
    # files; None for whole-file-on-home placement.  Immutable after
    # CREATE.  The home host (hosts[0] == this server) keeps size/wseq/
    # leases authoritative here even though chunk data is scattered.
    layout: Optional[Dict] = None
    # per-file CHUNK EPOCH, bumped under the file lock whenever committed
    # chunk bytes are destroyed (shrinking truncate, scrub clip) and
    # published at commit time: a scatter carries the epoch it was issued
    # under, stripe hosts refuse older epochs, and the commit WRITE is
    # rejected EPOCHSTALE unless its epoch matches — so a truncate that
    # interleaves another client's scatter→commit fails the commit cleanly
    # instead of silently clipping acknowledged bytes.  Persisted (unlike
    # wseq): a restart must not let a pre-restart scatter commit over a
    # post-truncate chunk store.
    epoch: int = 0
    # per-file ACL ([kind, id, allow, deny] entries, see perms.validate_acl)
    # mirrored from the dentry so STAT-side state and the persist blob agree
    # with what clients evaluate; None = mode bits alone decide.
    acl: Optional[List] = None


@dataclass
class DirEntry:
    name: str
    ino: int          # packed Inode (may point to another host)
    perm: PermRecord  # the ten extra bytes (paper §3.2)
    # stripe layout rides in the dentry next to the perm record, so a
    # client that cached the directory can plan a striped read/write with
    # zero metadata RPCs — the same trick the 10 permission bytes pull for
    # open()
    layout: Optional[Dict] = None
    # per-file ACL entries ride the dentry too (same trick again): a client
    # holding the parent directory evaluates user/group allow-deny grants
    # for any child locally, 0 RPCs.  None = plain mode bits.
    acl: Optional[List] = None


class BServer:
    """One BuffetFS storage server backed by a local directory (ext4 stand-in)."""

    def __init__(self, host_id: int, backing_dir: str, transport: Transport,
                 addr: str, *, version: int = 0, fsync_policy: str = "none",
                 dom_limit: int = 64 * 1024,
                 scrub_interval: Optional[float] = None,
                 lease_ttl_s: float = 5.0) -> None:
        self.host_id = host_id
        self.version = version
        self.backing_dir = backing_dir
        self.transport = transport
        self.addr = addr
        self.fsync_policy = fsync_policy
        self.dom_limit = dom_limit  # Lustre-DoM small-file threshold
        # every read-lease grant is time-bounded: the client stops serving
        # cached blocks once the TTL elapses (and silently re-validates),
        # so an unacked revoke can be WAITED OUT instead of force-broken,
        # and a promoted standby only has to outwait one TTL before its
        # first mutation rather than trust the dead incarnation's clients
        self.lease_ttl_s = lease_ttl_s
        # (hostID, version) -> addr map shared with the clients (the paper's
        # "local configuration file"), injected by BuffetCluster after all
        # servers exist: the home host uses it to orchestrate chunk objects
        # on stripe hosts for truncate/unlink/fsync of striped files.
        self.peers = None  # Optional[ClusterConfig]

        # the Lustre baseline verbs live in repro_torch.core.baselines and join
        # SERVER_OPS on import; import it here so every constructed BServer
        # serves the full verb set regardless of how the caller imported us
        # (runtime import: baselines -> cluster -> bserver would cycle at
        # module load time)
        from . import baselines  # noqa: F401

        self._objs = os.path.join(backing_dir, "objs")
        os.makedirs(self._objs, exist_ok=True)
        self._meta_path = os.path.join(backing_dir, "meta.json")

        self._lock = threading.RLock()
        self._file_locks: Dict[int, threading.Lock] = {}
        # per-directory mutation mutex: held across the §3.4 two-phase
        # (invalidate-and-wait, then apply) AND by directory reads, so the
        # server never hands out a snapshot taken inside a mutation window.
        # (A snapshot already in flight when the mutation starts is handled
        # client-side: BAgent refuses to mark a directory valid if its
        # invalidation generation moved during the fetch.)
        # Lock order: dir mutex BEFORE self._lock, never the reverse.
        self._dir_mutexes: Dict[int, threading.Lock] = {}
        self._next_file_id = ROOT_FILE_ID + 1
        self._meta: Dict[int, FileMeta] = {}
        self._dirs: Dict[int, Dict[str, DirEntry]] = {}
        # opened-file list: file_id -> {(client_id, pid, fd)}
        self._opened: Dict[int, Set[Tuple[str, int, int]]] = {}
        # per-directory caching clients: dir_file_id -> {client_id: callback_addr}
        self._watchers: Dict[int, Dict[str, str]] = {}
        # cluster-wide group-membership table (uid -> extra gids) and its
        # version.  Authoritative only on the root's home (host 0 by
        # convention) — other hosts keep it empty — but the machinery is
        # host-agnostic: a promoted standby restores it from the replica
        # blob and serves it under the same incarnation rules.
        self._groups: Dict[int, List[int]] = {}
        self._gver = 0
        # clients holding a fetched group table (the table's twin of
        # _watchers): client_id -> callback_addr, registered by
        # LOOKUP_GROUPS, invalidated (blocking) before SETGROUPS applies
        self._group_watchers: Dict[str, str] = {}
        # serializes SETGROUPS' invalidate-then-apply window (the group
        # table's _dir_mutex); LOOKUP_GROUPS snapshots under it too
        self._groups_mutex = threading.Lock()
        # read leases (data-plane twin of _watchers): file_id ->
        # {client_id: (callback_addr, grant_expiry)}.  Granted on READ with
        # a `lease_ttl_s` bound, recalled with a blocking REVOKE_LEASE
        # fan-out before any data mutation is acked.
        self._leases: Dict[int, Dict[str, Tuple[str, float]]] = {}
        # revokes that completed WITHOUT an ack AND could not be waited
        # out: with TTL-bounded leases this should stay 0 — an unreachable
        # holder's grant is simply outwaited (`lease_ttl_waits`), and an
        # already-expired grant is dropped without an RPC
        # (`lease_expired_drops`).  Kept as a counter so monitoring (and
        # the fig11 gate) can prove the stale-serve window stays closed.
        self.lease_breaks_forced = 0
        self.lease_ttl_waits = 0
        self.lease_expired_drops = 0
        # replication: home side ships its commit log to a standby;
        # standby side holds one ReplicaStore per replicated home and, on
        # promotion, the new serving instance it booted for the dead host
        self._repl: Optional[ReplicationLog] = None
        self._replicas: Dict[int, ReplicaStore] = {}
        self._promoted: Dict[int, "BServer"] = {}
        # a just-promoted standby must not apply data mutations until the
        # dead incarnation's outstanding lease grants have all expired:
        # monotonic deadline set at promotion, enforced in _revoke_leases
        self._mutation_barrier = 0.0
        self.promote_waits = 0
        self.promoted_records = 0  # log records replayed into this server
        # unlink chunk reaps that could not reach a stripe host:
        # (unreachable_host, dead_file_id) -> the chunk indices that were
        # being reaped.  Drained two ways by the scrubber — the stripe
        # host's own scrub asks us about the dead file (SCRUB_CLIP) and
        # reaps it, or OUR scrub pass retries the recorded CHUNK_UNLINK
        # (which also covers hosts holding no chunk file at all: a sparse
        # file's holes, or a reap that applied but whose ack was lost —
        # those would never send a SCRUB_CLIP, so debt keyed on their
        # chunks alone could never drain).  `chunk_reap_failures` counts
        # orphan debt still outstanding, not failures ever seen.
        self._reap_pending: Dict[Tuple[int, int], List[int]] = {}
        # EPOCHSTALE refusals served by this host: stale commits rejected
        # here (as a home host) plus stale scatters refused here (as a
        # stripe host).  Each one is a truncate-vs-scatter interleave that
        # would previously have clipped acknowledged bytes.
        self.epoch_rejects = 0
        # stripe-host epoch latch: (home_host, file_id) -> highest chunk
        # epoch any home-originated message (CHUNK_TRUNC) or accepted
        # scatter has carried.  CHUNK_WRITEs below the latch are refused,
        # so a truncate's clip fan-out makes every older in-flight scatter
        # self-invalidating before the truncate is acked.  Volatile: the
        # home host's commit-time epoch check is the persisted backstop.
        self._chunk_epochs: Dict[Tuple[int, int], int] = {}
        # periodic scrub passes that DIED (a bug, not an I/O outcome):
        # the worker swallows the exception to stay alive, but never
        # silently — a deployment relying on scrub_interval must be able
        # to see that its hygiene loop is broken (same discipline as the
        # agent's async_errors)
        self.scrub_failures = 0
        # chunk-replication health (r>1 layouts): missing replica copies
        # detected in the LAST scrub pass (a gauge — repair converges it
        # to zero) and copies successfully re-replicated from here, ever
        self.under_replicated = 0
        self.repaired_chunks = 0
        # peer heartbeat probing: last monotonic instant each peer
        # answered a HEARTBEAT probe sent from this server.  The cluster's
        # auto-promote monitor polls this view (HEARTBEAT {"view": true})
        # to gather its quorum of observers.
        self._hb_seen: Dict[int, float] = {}
        self._hb_stop = threading.Event()
        self._hb_interval: Optional[float] = None
        self.heartbeats_sent = 0
        self._stopped = False
        self.scrub_interval = scrub_interval
        self._scrub_stop = threading.Event()

        if os.path.exists(self._meta_path):
            self._load_meta()
        real = self.transport.serve(self.addr, self.handle)
        if real:  # TCP: ephemeral port resolved at bind time
            self.addr = real
        self._start_scrub_worker()

    # ------------------------------------------------------------------
    # lifecycle / persistence
    # ------------------------------------------------------------------
    def make_root(self, uid: int = 0, gid: int = 0, mode: int = 0o755) -> Inode:
        """Initialise the root directory on this server (host 0 by convention)."""
        with self._lock:
            if ROOT_FILE_ID not in self._meta:
                self._meta[ROOT_FILE_ID] = FileMeta(
                    perm=PermRecord(S_IFDIR | mode, uid, gid), is_dir=True,
                    ctime=time.time())
                self._dirs[ROOT_FILE_ID] = {}
                self._persist()
                self._jmeta(ROOT_FILE_ID)
                self._journal({"op": "dir", "fid": ROOT_FILE_ID})
        return Inode(self.host_id, self.version, ROOT_FILE_ID)

    def _persist(self) -> None:
        if self.fsync_policy == "none":
            return
        self._persist_now()

    @staticmethod
    def _meta_rec(m: FileMeta) -> Dict:
        """One FileMeta as its persist-blob dict — the unit the commit log
        ships (`{"op": "meta", ...}`) and `_persist_now` aggregates."""
        return {
            "mode": m.perm.mode, "uid": m.perm.uid, "gid": m.perm.gid,
            "size": m.size, "is_dir": m.is_dir, "nlink": m.nlink,
            "atime": m.atime, "mtime": m.mtime, "ctime": m.ctime,
            "xattrs": m.xattrs,
            **({"layout": m.layout} if m.layout else {}),
            **({"epoch": m.epoch} if m.epoch else {}),
            **({"acl": m.acl} if m.acl else {}),
        }

    @staticmethod
    def _entry_rec(e: DirEntry) -> Dict:
        return {"ino": e.ino, "perm": e.perm.pack().hex(),
                **({"layout": e.layout} if e.layout else {}),
                **({"acl": e.acl} if e.acl else {})}

    def _meta_blob_locked(self) -> Dict:
        return {
            "next_file_id": self._next_file_id,
            "meta": {str(fid): self._meta_rec(m)
                     for fid, m in self._meta.items()},
            "dirs": {
                str(fid): {name: self._entry_rec(e)
                           for name, e in entries.items()}
                for fid, entries in self._dirs.items()
            },
            # group table + version ride the same blob so a promoted
            # standby (materialize -> _load_meta) restores grants intact
            "groups": {str(uid): gids
                       for uid, gids in self._groups.items()},
            "gver": self._gver,
        }

    def _persist_now(self) -> None:
        blob = self._meta_blob_locked()
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def _load_meta(self) -> None:
        with open(self._meta_path) as f:
            blob = json.load(f)
        self._next_file_id = blob["next_file_id"]
        self._meta = {
            int(fid): FileMeta(
                perm=PermRecord(d["mode"], d["uid"], d["gid"]), size=d["size"],
                is_dir=d["is_dir"], nlink=d["nlink"], atime=d["atime"],
                mtime=d["mtime"], ctime=d["ctime"], xattrs=d.get("xattrs", {}),
                layout=d.get("layout"), epoch=d.get("epoch", 0),
                acl=d.get("acl"))
            for fid, d in blob["meta"].items()
        }
        self._dirs = {
            int(fid): {
                name: DirEntry(name, e["ino"],
                               PermRecord.unpack(bytes.fromhex(e["perm"])),
                               layout=e.get("layout"), acl=e.get("acl"))
                for name, e in entries.items()
            } for fid, entries in blob["dirs"].items()
        }
        self._groups = normalize_groups(blob.get("groups"))
        self._gver = blob.get("gver", 0)

    def shutdown(self) -> None:
        self._scrub_stop.set()
        self._hb_stop.set()
        if self._repl is not None:
            self._repl.stop()
        with self._lock:
            self._stopped = True
            self._persist_now()
        self.transport.shutdown(self.addr)

    def restart(self, *, crash: bool = False) -> None:
        """Simulate a server reboot/restore (paper §3.2 version segment).

        On restart the incarnation `version` increments so every inode minted
        by the previous incarnation is detectably stale; volatile state (the
        opened-file list and watcher registry) is lost, exactly as a real
        reboot would lose it.
        """
        with self._lock:
            if not crash:
                self._persist_now()
            self.version += 1
            self._opened.clear()
            self._watchers.clear()
            self._group_watchers.clear()
            self._leases.clear()
            # the stripe-host epoch latch is volatile too; the home host's
            # persisted per-file epoch is what stale commits die against
            self._chunk_epochs.clear()
            # staged replicas of OTHER homes are dropped like any volatile
            # state: a real reboot loses the in-memory handle.  What makes
            # this cheap instead of catastrophic is the ReplicaStore's
            # persisted repl_state.json — the store lazily rebuilt by the
            # next REPL_APPEND reloads it and resumes incrementally, so a
            # standby reboot no longer forces a full snapshot resync.
            self._replicas.clear()
            if os.path.exists(self._meta_path):
                self._load_meta()
            self._stopped = False
        # close the previous incarnation's listener before rebinding: a
        # reboot of a live server (no prior shutdown()) would otherwise
        # EADDRINUSE on real sockets (InProc shutdown is an idempotent pop)
        self.transport.shutdown(self.addr)
        self.transport.serve(self.addr, self.handle)
        self._start_scrub_worker()
        # a rebooted home restarts its shipper and re-seeds the standby
        # with a fresh snapshot: a kill/shutdown stopped the old shipper
        # thread for good, and the crash may have rolled local state
        # behind what was already shipped (fsync_policy="none" reloads an
        # old meta.json) — the replica must converge to what THIS
        # incarnation now serves
        if self._repl is not None:
            self.start_replication(self._repl.target_host)
        if self._hb_interval is not None:
            self.start_heartbeats(self._hb_interval)

    def start_heartbeats(self, interval_s: float) -> None:
        """Probe every peer with a HEARTBEAT frame each `interval_s` on a
        background thread, recording the last instant each answered.
        Idempotent: a restart (or reconfiguration) replaces the thread."""
        self._hb_stop.set()
        self._hb_stop = threading.Event()
        self._hb_interval = interval_s
        stop = self._hb_stop
        # seed the view so "never answered yet" ages from thread start,
        # not from the epoch — a freshly booted cluster must not look
        # like every peer has been dead forever
        now = time.monotonic()
        if self.peers is not None:
            for peer in self.peers.hosts():
                if peer != self.host_id:
                    self._hb_seen.setdefault(peer, now)

        def loop() -> None:
            while not stop.wait(interval_s):
                if self._stopped or self.peers is None:
                    continue
                for peer in self.peers.hosts():
                    if peer == self.host_id:
                        continue
                    try:
                        resp = self.transport.request(
                            self.peers.addr(peer),
                            Message(MsgType.HEARTBEAT,
                                    {"home": self.host_id}))
                    except Exception:
                        continue
                    self.heartbeats_sent += 1
                    if resp.type is not MsgType.ERROR:
                        self._hb_seen[peer] = time.monotonic()

        threading.Thread(target=loop, name=f"hb-{self.host_id}",
                         daemon=True).start()

    def _start_scrub_worker(self) -> None:
        """Periodic scrubber: every `scrub_interval` seconds run one scrub
        pass over this host's own chunk store.  On-demand passes (the SCRUB
        verb) share the same `scrub_pass` body; None disables the worker
        (scrubbing then only runs when a client asks for it)."""
        if self.scrub_interval is None:
            return
        self._scrub_stop = threading.Event()  # fresh event after restart
        stop = self._scrub_stop

        def loop() -> None:
            while not stop.wait(self.scrub_interval):
                if self._stopped:
                    continue
                try:
                    self.scrub_pass()
                except Exception:
                    # keep the worker alive, but COUNT the breakage: a
                    # scrub pass raising is a bug (per-host I/O failures
                    # already come back as scrub_errors counts, not
                    # exceptions), and a silently dead hygiene loop would
                    # let orphans accumulate unseen
                    with self._lock:
                        self.scrub_failures += 1

        threading.Thread(target=loop, daemon=True).start()

    @property
    def chunk_reap_failures(self) -> int:
        """Orphaned-chunk debt from unlink reaps that could not reach their
        stripe host — drained back to zero as scrub passes reap them."""
        with self._lock:
            return len(self._reap_pending)

    # ------------------------------------------------------------------
    # commit-log replication (home side) — see repro_torch.core.repl
    # ------------------------------------------------------------------
    def start_replication(self, target_host: int) -> None:
        """Begin shipping this server's commit log to `target_host`
        asynchronously, seeded with a full snapshot so a standby that
        joins late (or lost its state) converges from nothing."""
        if self._repl is not None:
            self._repl.stop()
        self._repl = ReplicationLog(self, target_host)
        self._repl_seed()

    def _journal(self, rec: Dict, payload: bytes = b"") -> None:
        """Append one commit record to the replication log (no-op while
        replication is off).  Metadata records MUST be appended inside the
        same `self._lock` hold as the mutation they describe, and data
        records only after their bytes are on disk — the snapshot reset in
        `ReplicationLog.begin_snapshot` relies on both orderings."""
        r = self._repl
        if r is not None:
            r.append(rec, payload)

    def _jmeta(self, fid: int) -> None:
        """Journal the current FileMeta of `fid` (caller holds _lock)."""
        m = self._meta.get(fid)
        if m is not None:
            self._journal({"op": "meta", "fid": fid, "m": self._meta_rec(m)})

    def _repl_seed(self) -> None:
        """(Re-)seed the standby: snapshot the metadata atomically with a
        log reset, then walk the object store and ship every object/chunk
        as data records.  Concurrent mutations keep journaling normally;
        records that raced the reset are subsumed by the snapshot (meta)
        or re-read by this walk (data)."""
        repl = self._repl
        if repl is None:
            return
        with self._lock:
            repl.begin_snapshot(self._meta_blob_locked())
        chunk_sz = 1 << 20
        for name in sorted(os.listdir(self._objs)):
            path = os.path.join(self._objs, name)
            if name.startswith("c"):
                try:
                    home_s, fid_s, idx_s = name[1:].split("_")
                    base = {"op": "cdata", "home": int(home_s, 16),
                            "fid": int(fid_s, 16), "idx": int(idx_s, 16)}
                except ValueError:
                    continue
            else:
                try:
                    base = {"op": "odata", "fid": int(name, 16)}
                except ValueError:
                    continue
            try:
                with open(path, "rb") as f:
                    off = 0
                    while True:
                        data = f.read(chunk_sz)
                        if not data and off:
                            break
                        self._journal({**base, "off": off}, data)
                        if len(data) < chunk_sz:
                            break
                        off += len(data)
            except OSError:
                continue  # reaped mid-walk: its deletion record covers it

    def _repl_send(self, target: int, msg: Message) -> Message:
        return self._request_host(target, msg)

    def repl_drain(self, timeout: float = 10.0) -> bool:
        """Block until the standby acked every shipped record (tests and
        benchmarks use this to make lag assertions deterministic)."""
        return self._repl.drain(timeout) if self._repl is not None else True

    def repl_stats(self) -> Dict[str, int]:
        """Replication/failover health for io_stats(): shipping lag plus
        the lease-TTL and promotion counters."""
        out: Dict[str, int] = {
            "replica_homes": len(self._replicas),
            "lease_ttl_waits": self.lease_ttl_waits,
            "lease_expired_drops": self.lease_expired_drops,
            "promote_waits": self.promote_waits,
            "promoted_records": self.promoted_records,
            "heartbeats_sent": self.heartbeats_sent,
        }
        if self._repl is not None:
            out.update(self._repl.stats())
        return out

    @SERVER_OPS.register(MsgType.REPL_APPEND, mutating=True)
    def _op_repl_append(self, h: Dict, p: bytes) -> Message:
        """Standby side: apply one batch of a home's commit log.  The
        payload is consumed synchronously (data records write straight to
        the staging store), so the zero-copy payload view never outlives
        the handler."""
        home = h["home"]
        with self._lock:
            store = self._replicas.get(home)
            if store is None:
                store = self._replicas[home] = ReplicaStore(
                    home, os.path.join(self.backing_dir, f"repl_{home:03d}"))
        return ok(store.apply_batch(h["seq"], h["recs"], p,
                                    h.get("hver", 0)))

    # ------------------------------------------------------------------
    # promotion (standby -> new home authority)
    # ------------------------------------------------------------------
    def promote_peer(self, home: int) -> "BServer":
        """Promote this standby's replica of `home` into a live serving
        instance: materialize the replicated state into a backing dir on
        THIS host's disk, boot a fresh BServer under the dead host's
        identity with a bumped incarnation, and fence its first mutation
        behind one lease TTL (the dead incarnation's clients stop serving
        their cached blocks at expiry — no revoke can reach the grant
        table that died with the home).  The caller re-points the cluster
        config; clients find the new authority via their normal
        ESTALE/refused retry path."""
        with self._lock:
            store = self._replicas.pop(home, None)
        if store is None:
            raise KeyError(f"no replica state for host {home}")
        backing = store.materialize()
        from .transport import TCPTransport
        version = store.hver + 1
        addr = ("127.0.0.1:0" if isinstance(self.transport, TCPTransport)
                else f"bserver:{home}p{version}")
        srv = BServer(home, backing, self.transport, addr,
                      version=version, fsync_policy=self.fsync_policy,
                      dom_limit=self.dom_limit, lease_ttl_s=self.lease_ttl_s)
        srv.peers = self.peers
        srv._mutation_barrier = time.monotonic() + srv.lease_ttl_s
        srv.promoted_records = store.records_applied
        with self._lock:
            self._promoted[home] = srv
        return srv

    @SERVER_OPS.register(MsgType.PROMOTE, mutating=True)
    def _op_promote(self, h: Dict, _p: bytes) -> Message:
        try:
            srv = self.promote_peer(h["home"])
        except KeyError as e:
            return error(errno.ENOENT, str(e))
        return ok({"home": h["home"], "addr": srv.addr,
                   "version": srv.version,
                   "records": srv.promoted_records})

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _obj_path(self, file_id: int) -> str:
        return os.path.join(self._objs, f"{file_id:016x}")

    def _chunk_path(self, home: int, file_id: int, index: int) -> str:
        """Chunk objects live in the same ext4-backed object store, keyed
        by (home_host, file_id, stripe_index) — the `c` prefix and the
        home-host component keep them disjoint from this server's own
        file_id namespace."""
        return os.path.join(self._objs, f"c{home:03x}_{file_id:016x}_{index:08x}")

    def _chunk_lock(self, home: int, file_id: int, index: int
                    ) -> threading.Lock:
        with self._lock:
            key = -(((home << 40) ^ file_id) * 1048576 + index + 1)
            lk = self._file_locks.get(key)
            if lk is None:
                lk = self._file_locks[key] = threading.Lock()
            return lk

    def _fanout_chunks(self, by_host: Dict[int, Message]) -> List[int]:
        """Home-host orchestration hop: send one chunk RPC to each stripe
        host.  Sequential on purpose — this handler may itself be running
        on a transport pool worker, so fanning out through the pool could
        exhaust the workers it waits on.  Returns the hosts whose fan-out
        FAILED (unreachable, errored, or unroutable): the truncate/unlink
        callers treat failures as best-effort orphans (the same
        availability escape the §3.4 watcher fan-out and lease revocation
        take) — unlink records them in `_reap_pending` for the scrubber —
        but a durability barrier (fsync) must refuse to ack on them."""
        failed: List[int] = []
        for host, msg in by_host.items():
            if host == self.host_id:
                resp = SERVER_OPS.dispatch(self, msg)  # local: no self-RPC
            elif self.peers is None:
                failed.append(host)
                continue
            else:
                try:
                    resp = self.transport.request(self.peers.addr(host), msg,
                                                  critical=True)
                except Exception:
                    failed.append(host)
                    continue
            if resp.type is MsgType.ERROR:
                failed.append(host)
        return failed

    @staticmethod
    def _chunk_trunc_plan(layout: Dict, old_size: int, new_size: int
                          ) -> Dict[int, List[List[int]]]:
        """Per-stripe-host clip/delete plan for a truncate: chunks wholly
        beyond the new size are deleted (len -1), the chunk containing the
        new EOF is clipped, chunks below it are untouched.  Physical
        clipping matters: a later extend-write must read the reclaimed
        range as zeros, not as resurrected pre-truncate bytes."""
        ss = layout["ss"]
        plan: Dict[int, List[List[int]]] = {}
        for idx in range((old_size + ss - 1) // ss):
            start = idx * ss
            if start >= new_size:
                op = [idx, -1]
            elif start + ss > new_size:
                op = [idx, new_size - start]
            else:
                continue
            # every replica holds the chunk, so every replica gets the clip
            for host in chunk_hosts(layout, idx):
                plan.setdefault(host, []).append(op)
        return plan

    @staticmethod
    def _chunk_indices_by_host(layout: Dict, size: int
                               ) -> Dict[int, List[int]]:
        """Which chunk indices each host holds (ALL replicas, not just
        primaries): the unlink-reap and fsync fan-outs cover every copy,
        and the reap debt recorded for an unreachable host covers the
        replica copies it held too — without this, k-1 orphan copies of
        every chunk would leak forever."""
        ss = layout["ss"]
        out: Dict[int, List[int]] = {}
        for idx in range((size + ss - 1) // ss):
            for host in chunk_hosts(layout, idx):
                out.setdefault(host, []).append(idx)
        return out

    def _inode(self, file_id: int) -> int:
        return Inode(self.host_id, self.version, file_id).pack()

    def _file_lock(self, file_id: int) -> threading.Lock:
        with self._lock:
            lk = self._file_locks.get(file_id)
            if lk is None:
                lk = self._file_locks[file_id] = threading.Lock()
            return lk

    def _dir_mutex(self, dir_file_id: int) -> threading.Lock:
        with self._lock:
            mtx = self._dir_mutexes.get(dir_file_id)
            if mtx is None:
                mtx = self._dir_mutexes[dir_file_id] = threading.Lock()
            return mtx

    def _check_version(self, header: Dict) -> Optional[Message]:
        v = header.get("ver")
        if v is not None and v != self.version:
            return error(errno.ESTALE, f"server incarnation {self.version} != {v}")
        return None

    def _alloc(self, meta: FileMeta) -> int:
        fid = self._next_file_id
        self._next_file_id += 1
        self._meta[fid] = meta
        return fid

    # ------------------------------------------------------------------
    # invalidation fan-out (§3.4)
    # ------------------------------------------------------------------
    def _invalidate_watchers(self, dir_file_id: int, names: Optional[List[str]] = None,
                             exclude_client: Optional[str] = None) -> None:
        """Block until every caching client acks invalidation, THEN the caller
        applies the mutation — this ordering is the paper's strong-consistency
        guarantee."""
        with self._lock:
            watchers = dict(self._watchers.get(dir_file_id, {}))
        for client_id, cb_addr in watchers.items():
            if client_id == exclude_client:
                continue
            resp = self.transport.request(
                cb_addr,
                Message(MsgType.INVALIDATE,
                        {"dir_ino": self._inode(dir_file_id), "names": names}),
                critical=True)
            if resp.type is not MsgType.OK:
                # unreachable client: drop it from the registry (it will
                # re-register and re-fetch on next access)
                with self._lock:
                    self._watchers.get(dir_file_id, {}).pop(client_id, None)

    def _revoke_leases(self, file_id: int,
                       exclude_client: Optional[str] = None) -> None:
        """Recall every read lease on a file, BLOCKING until each holder
        acks (or proves unreachable) — only then may the caller apply (or,
        for unlink, acknowledge) the data mutation.  This ordering is what
        makes a client page-cache hit indistinguishable from a read RPC:
        a stale block can never be served after the mutation returns.

        The writer's own lease survives (`exclude_client`): its agent
        patches its cache from the write path, and revoking it would only
        thrash the cache it is about to update.

        Every grant is TTL-bounded, which closes the old stale-serve
        window: an already-expired grant is dropped without an RPC (the
        client stopped serving it at expiry on its own clock, which runs
        AHEAD of ours — it stamped the grant before sending the READ); an
        unacked revoke on a live grant is WAITED OUT to its expiry instead
        of force-broken.  A freshly promoted standby additionally waits
        out one full TTL before its first mutation (`_mutation_barrier`):
        the dead incarnation's grant table died with it, so the only safe
        assumption is that every one of its grants is still live."""
        barrier = self._mutation_barrier
        if barrier:
            delay = barrier - time.monotonic()
            if delay > 0:
                time.sleep(delay)
                with self._lock:
                    self.promote_waits += 1
        with self._lock:
            holders = dict(self._leases.get(file_id, {}))
        for client_id, (cb_addr, expires) in holders.items():
            if client_id == exclude_client:
                continue
            if time.monotonic() >= expires:
                with self._lock:
                    self.lease_expired_drops += 1
            else:
                resp = self.transport.request(
                    cb_addr,
                    Message(MsgType.REVOKE_LEASE,
                            {"ino": self._inode(file_id)}),
                    critical=True)
                if resp.type is not MsgType.OK:
                    # unreachable/timed-out holder: outwait the grant —
                    # the client's own expiry check makes its cache go
                    # cold no later than `expires`, so after this sleep
                    # the strong guarantee holds WITHOUT the holder's ack
                    remaining = expires - time.monotonic()
                    if remaining > 0:
                        time.sleep(remaining)
                    with self._lock:
                        self.lease_ttl_waits += 1
            with self._lock:
                tbl = self._leases.get(file_id)
                if tbl is not None:
                    tbl.pop(client_id, None)
                    if not tbl:
                        del self._leases[file_id]

    def _two_phase(self, parent: int, names: List[str], check, apply,
                   exclude_client: Optional[str] = None,
                   post_apply=None) -> Message:
        """§3.4 two-phase scaffold shared by every namespace mutation.

        Under the directory's mutation mutex: (1) `check` runs under the
        meta lock and may refuse by returning a Message — nothing has been
        invalidated yet, so a refused mutation costs the watchers nothing;
        (2) the invalidation fan-out BLOCKS until every watcher acks;
        (3) only then does `apply` run, under the meta lock.  The mutex
        also serializes directory reads against the (2)-(3) window.

        `post_apply` (if given) runs after a successful apply, outside the
        meta lock but still inside the mutex — unlink uses it to recall
        read leases on the removed file before the client is acked (once
        apply removed the object, no NEW lease can be granted, so
        revoke-after-apply-before-ack leaves no stale-grant window)."""
        with self._dir_mutex(parent):
            with self._lock:
                refusal = check()
                if refusal is not None:
                    return refusal
            self._invalidate_watchers(parent, names,
                                      exclude_client=exclude_client)
            with self._lock:
                resp = apply()
            if post_apply is not None and resp.type is not MsgType.ERROR:
                post_apply()
            return resp

    # ------------------------------------------------------------------
    # request dispatch — through the shared service-layer registry; the
    # BATCH envelope is unpacked and executed generically there
    # ------------------------------------------------------------------
    def handle(self, msg: Message) -> Message:
        if self._stopped:
            return error(errno.ECONNREFUSED, "server stopped")
        stale = self._check_version(msg.header)
        # PING and HEARTBEAT answer regardless of the sender's incarnation
        # belief: both exist precisely so a peer with a stale config can
        # re-learn the live version / observe liveness
        if stale is not None and msg.type not in (MsgType.PING,
                                                  MsgType.HEARTBEAT):
            return stale
        return SERVER_OPS.dispatch(self, msg)

    # --- namespace ops -------------------------------------------------
    @SERVER_OPS.register(MsgType.LOOKUP_DIR)
    def _op_lookup_dir(self, h: Dict, _p: bytes) -> Message:
        """Return a directory's full data: dentries WITH the 10-byte perm
        records, and register the requesting client for invalidation.  The
        dir mutex serializes this against a mutation's invalidate+apply
        window (§3.4): a revalidation sees the directory either before the
        fan-out or after the apply, never in between."""
        fid = h["file_id"]
        with self._dir_mutex(fid):
            with self._lock:
                meta = self._meta[fid]
                if not meta.is_dir:
                    return error(errno.ENOTDIR, "not a directory")
                entries = [
                    {"name": e.name, "ino": e.ino, "perm": e.perm.pack().hex(),
                     **({"layout": e.layout} if e.layout else {}),
                     **({"acl": e.acl} if e.acl else {})}
                    for e in self._dirs[fid].values()
                ]
                if "client_id" in h and h.get("cb_addr"):
                    self._watchers.setdefault(fid, {})[h["client_id"]] = h["cb_addr"]
                dperm = meta.perm.pack().hex()
                gver = self._gver
        hdr = {"entries": entries, "perm": dperm, "ino": self._inode(fid)}
        if gver:  # group-table authority: advertise the version (slot 18)
            hdr["gver"] = gver
        return ok(hdr)

    @SERVER_OPS.register(MsgType.STAT)
    def _op_stat(self, h: Dict, _p: bytes) -> Message:
        fid = h["file_id"]
        with self._lock:
            m = self._meta[fid]
            return ok({"ino": self._inode(fid), "size": m.size,
                       "mode": m.perm.mode, "uid": m.perm.uid, "gid": m.perm.gid,
                       "nlink": m.nlink, "atime": m.atime, "mtime": m.mtime,
                       "ctime": m.ctime, "is_dir": m.is_dir})

    @SERVER_OPS.register(MsgType.CREATE, mutating=True)
    def _op_create(self, h: Dict, _p: bytes) -> Message:
        parent, name = h["parent"], h["name"]
        perm = PermRecord(S_IFREG | (h["mode"] & 0o777), h["uid"], h["gid"])
        layout = h.get("layout")  # stripe layout allocated client-side

        # a batched CREATE burst goes through here per sub-message, so the
        # §3.4 ordering holds for batches exactly as for single RPCs
        def check() -> Optional[Message]:
            e = self._dirs[parent].get(name)
            if e is None:
                return None
            if h.get("excl"):
                return error(errno.EEXIST, name)
            hdr = {"ino": e.ino, "perm": e.perm.pack().hex(),
                   "existed": True}
            if e.layout:  # the EXISTING layout wins: layouts are immutable
                hdr["layout"] = e.layout
            return ok(hdr)

        def apply() -> Message:
            pdir = self._dirs.get(parent)
            if pdir is None:  # parent rmdir'd during the fan-out: allocate
                return error(errno.ENOENT, name)  # nothing, leak nothing
            fid = self._alloc(FileMeta(perm=perm, ctime=time.time(),
                                       mtime=time.time(), layout=layout))
            ino = self._inode(fid)
            pdir[name] = DirEntry(name, ino, perm, layout=layout)
            # front-end metadata mirrored into xattrs of the file (§3.2)
            self._meta[fid].xattrs["buffet.ino"] = str(ino)
            if layout is None:
                open(self._obj_path(fid), "wb").close()
            self._persist()
            self._jmeta(fid)
            self._journal({"op": "dentry", "dir": parent, "name": name,
                           "e": self._entry_rec(pdir[name])})
            self._journal({"op": "next_fid", "v": self._next_file_id})
            hdr = {"ino": ino, "perm": perm.pack().hex(), "existed": False}
            if layout:
                hdr["layout"] = layout
            return ok(hdr)

        return self._two_phase(parent, [name], check, apply,
                               exclude_client=h.get("client_id"))

    @SERVER_OPS.register(MsgType.MKDIR, mutating=True)
    def _op_mkdir(self, h: Dict, _p: bytes) -> Message:
        parent, name = h["parent"], h["name"]
        perm = PermRecord(S_IFDIR | (h["mode"] & 0o777), h["uid"], h["gid"])

        def check() -> Optional[Message]:
            if name in self._dirs[parent]:
                return error(errno.EEXIST, name)
            return None

        def apply() -> Message:
            pdir = self._dirs.get(parent)
            if pdir is None:  # parent rmdir'd during the fan-out
                return error(errno.ENOENT, name)
            fid = self._alloc(FileMeta(perm=perm, is_dir=True,
                                       ctime=time.time()))
            self._dirs[fid] = {}
            ino = self._inode(fid)
            pdir[name] = DirEntry(name, ino, perm)
            self._persist()
            self._jmeta(fid)
            self._journal({"op": "dir", "fid": fid})
            self._journal({"op": "dentry", "dir": parent, "name": name,
                           "e": self._entry_rec(pdir[name])})
            self._journal({"op": "next_fid", "v": self._next_file_id})
            return ok({"ino": ino, "perm": perm.pack().hex()})

        return self._two_phase(parent, [name], check, apply,
                               exclude_client=h.get("client_id"))

    @SERVER_OPS.register(MsgType.UNLINK, mutating=True, breaks_lease=True)
    def _op_unlink(self, h: Dict, _p: bytes) -> Message:
        parent, name = h["parent"], h["name"]
        # local (file_id, layout, size) whose leases/chunks must be reaped
        unlinked: List[Tuple[int, Optional[Dict], int]] = []

        def check() -> Optional[Message]:
            e = self._dirs[parent].get(name)
            if e is None:
                return error(errno.ENOENT, name)
            if e.perm.is_dir:
                return error(errno.EISDIR, name)
            return None

        def apply() -> Message:
            e = self._dirs[parent].pop(name)
            ino = Inode.unpack(e.ino)
            if ino.host_id == self.host_id:
                m = self._meta.pop(ino.file_id, None)
                unlinked.append((ino.file_id,
                                 m.layout if m else None,
                                 m.size if m else 0))
                try:
                    os.unlink(self._obj_path(ino.file_id))
                except FileNotFoundError:
                    pass
                self._journal({"op": "meta_del", "fid": ino.file_id})
            self._persist()
            self._journal({"op": "dentry_del", "dir": parent, "name": name})
            return ok()

        def post_apply() -> None:
            # revoke-after-apply-before-ack: the object is already gone, so
            # no new lease can be granted (READ now fails ENOENT), and every
            # pre-apply lease is recalled before the unlinker gets its OK —
            # no client can serve stale blocks for a path whose unlink
            # completed.  (A cross-host object keeps its data unchanged
            # until GC'd, so its leases are not stale and stay untouched.)
            for fid, layout, size in unlinked:
                self._revoke_leases(fid,
                                    exclude_client=h.get("client_id"))
                # the file_id is dead and never reused: drop the whole
                # table (the excluded unlinker's entry would otherwise
                # leak forever — no later mutation will ever touch it)
                with self._lock:
                    self._leases.pop(fid, None)
                if layout is not None:
                    # reap the dead file's chunk objects on their stripe
                    # hosts (best-effort, like the revokes above: an
                    # unreachable host leaves orphans, never blocks unlink).
                    # Failed hosts are RECORDED, not forgotten: the orphans
                    # they hold are debt the scrubber pays down, and
                    # `chunk_reap_failures` stays nonzero until it does.
                    by_host = self._chunk_indices_by_host(layout, size)
                    reap_failed = self._fanout_chunks({
                        host: Message(MsgType.CHUNK_UNLINK,
                                      {"home": self.host_id, "file_id": fid,
                                       "indices": idxs})
                        for host, idxs in by_host.items()})
                    if reap_failed:
                        with self._lock:
                            for host in reap_failed:
                                self._reap_pending[(host, fid)] = \
                                    by_host[host]

        return self._two_phase(parent, [name], check, apply,
                               exclude_client=h.get("client_id"),
                               post_apply=post_apply)

    @SERVER_OPS.register(MsgType.RMDIR, mutating=True)
    def _op_rmdir(self, h: Dict, _p: bytes) -> Message:
        parent, name = h["parent"], h["name"]

        def check() -> Optional[Message]:
            e = self._dirs[parent].get(name)
            if e is None:
                return error(errno.ENOENT, name)
            if not e.perm.is_dir:
                return error(errno.ENOTDIR, name)
            if self._dirs.get(Inode.unpack(e.ino).file_id):
                # reject BEFORE the fan-out: a failing rmdir must not blow
                # away every watcher's cache for nothing
                return error(errno.ENOTEMPTY, name)
            return None

        def apply() -> Message:
            # re-check: the child dir is guarded by its OWN mutex, so a
            # CREATE inside it can land during our fan-out — deleting now
            # would orphan those files
            e = self._dirs[parent].get(name)
            if e is None:
                return error(errno.ENOENT, name)
            fid = Inode.unpack(e.ino).file_id
            if self._dirs.get(fid):
                return error(errno.ENOTEMPTY, name)
            del self._dirs[parent][name]
            self._dirs.pop(fid, None)
            self._meta.pop(fid, None)
            self._persist()
            self._journal({"op": "dentry_del", "dir": parent, "name": name})
            self._journal({"op": "dir_del", "fid": fid})
            self._journal({"op": "meta_del", "fid": fid})
            return ok()

        return self._two_phase(parent, [name], check, apply,
                               exclude_client=h.get("client_id"))

    @SERVER_OPS.register(MsgType.RENAME, mutating=True)
    def _op_rename(self, h: Dict, _p: bytes) -> Message:
        parent, old, new = h["parent"], h["old"], h["new"]

        def check() -> Optional[Message]:
            if old not in self._dirs[parent]:
                return error(errno.ENOENT, old)
            return None

        def apply() -> Message:
            pdir = self._dirs[parent]
            e = pdir.pop(old)
            # the layout (and ACL) travels WITH the dentry: dropping it
            # here would turn a renamed striped file into an unreadable one
            # for every client that resolves the new name
            pdir[new] = DirEntry(new, e.ino, e.perm, layout=e.layout,
                                 acl=e.acl)
            self._persist()
            self._journal({"op": "dentry_del", "dir": parent, "name": old})
            self._journal({"op": "dentry", "dir": parent, "name": new,
                           "e": self._entry_rec(pdir[new])})
            return ok()

        return self._two_phase(parent, [old, new], check, apply,
                               exclude_client=h.get("client_id"))

    # --- permission changes (§3.4: invalidate BEFORE applying) ---------
    @SERVER_OPS.register(MsgType.CHMOD, mutating=True)
    def _op_chmod(self, h: Dict, _p: bytes) -> Message:
        return self._perm_change(h, lambda perm: perm.with_mode_bits(h["mode"]))

    @SERVER_OPS.register(MsgType.CHOWN, mutating=True)
    def _op_chown(self, h: Dict, _p: bytes) -> Message:
        return self._perm_change(
            h, lambda perm: PermRecord(perm.mode, h["uid"], h["gid"]))

    def _perm_change(self, h: Dict, f) -> Message:
        parent, name = h["parent"], h["name"]

        def check() -> Optional[Message]:
            if name not in self._dirs[parent]:
                return error(errno.ENOENT, name)
            return None

        def apply() -> Message:
            pdir = self._dirs[parent]
            e = pdir[name]
            new_perm = f(e.perm)
            # preserve the stripe layout and ACL riding in the dentry (see
            # rename)
            pdir[name] = DirEntry(name, e.ino, new_perm, layout=e.layout,
                                  acl=e.acl)
            ino = Inode.unpack(e.ino)
            if ino.host_id == self.host_id and ino.file_id in self._meta:
                self._meta[ino.file_id].perm = new_perm
                self._meta[ino.file_id].ctime = time.time()
                self._jmeta(ino.file_id)
            self._persist()
            self._journal({"op": "dentry", "dir": parent, "name": name,
                           "e": self._entry_rec(pdir[name])})
            return ok({"perm": new_perm.pack().hex()})

        # no exclude_client: even the caller's own cache must revalidate
        return self._two_phase(parent, [name], check, apply)

    @SERVER_OPS.register(MsgType.SETACL, mutating=True)
    def _op_setacl(self, h: Dict, _p: bytes) -> Message:
        """Replace one dentry's ACL.  Same shape as CHMOD (§3.4: every
        watcher invalidated and acked BEFORE the new ACL applies), so a
        client-cached grant can never authorize an access after the
        withdrawal is acknowledged — revoke-before-ack, like writes."""
        parent, name = h["parent"], h["name"]
        try:
            acl = validate_acl(h.get("acl"))
        except FSError as e:
            return error(e.errno, str(e))

        def check() -> Optional[Message]:
            if name not in self._dirs[parent]:
                return error(errno.ENOENT, name)
            return None

        def apply() -> Message:
            pdir = self._dirs[parent]
            e = pdir[name]
            pdir[name] = DirEntry(name, e.ino, e.perm, layout=e.layout,
                                  acl=acl)
            ino = Inode.unpack(e.ino)
            if ino.host_id == self.host_id and ino.file_id in self._meta:
                self._meta[ino.file_id].acl = acl
                self._meta[ino.file_id].ctime = time.time()
                self._jmeta(ino.file_id)
            self._persist()
            self._journal({"op": "dentry", "dir": parent, "name": name,
                           "e": self._entry_rec(pdir[name])})
            return ok({"acl": acl})

        # no exclude_client: even the caller's own cache must revalidate
        return self._two_phase(parent, [name], check, apply)

    def _invalidate_group_watchers(self) -> None:
        """Group-table twin of `_invalidate_watchers`: block until every
        client holding a fetched table acks the invalidation, THEN the
        caller applies the membership change.  Unreachable clients are
        dropped from the registry (their next table use refetches)."""
        with self._lock:
            watchers = dict(self._group_watchers)
        for client_id, cb_addr in watchers.items():
            resp = self.transport.request(
                cb_addr, Message(MsgType.INVALIDATE, {"groups": True}),
                critical=True)
            if resp.type is not MsgType.OK:
                with self._lock:
                    self._group_watchers.pop(client_id, None)

    @SERVER_OPS.register(MsgType.SETGROUPS, mutating=True)
    def _op_setgroups(self, h: Dict, _p: bytes) -> Message:
        """Replace one uid's extra group memberships in the cluster-wide
        table.  Invalidate-then-apply under the table's own mutex: by the
        time the caller is acked, no client can evaluate a "g" ACL entry
        against the withdrawn membership."""
        uid, gids = h["uid"], h.get("gids") or []
        if (not isinstance(uid, int) or uid < 0
                or not all(isinstance(g, int) and g >= 0 for g in gids)):
            return error(errno.EINVAL, "uid/gids must be non-negative ints")
        with self._groups_mutex:
            # buffetlint: ignore[LOCK001] the table mutex must span the
            # invalidate fan-out AND the apply: released between them, a
            # concurrent LOOKUP_GROUPS could snapshot the old table after
            # its holder acked the withdrawal — breaking revoke-before-ack
            # for the one cluster-global structure this mutex guards
            self._invalidate_group_watchers()
            with self._lock:
                if gids:
                    self._groups[uid] = list(gids)
                else:
                    self._groups.pop(uid, None)
                self._gver += 1
                self._persist()
                self._journal({"op": "groups",
                               "g": {str(u): g
                                     for u, g in self._groups.items()},
                               "gver": self._gver})
                return ok({"gver": self._gver})

    @SERVER_OPS.register(MsgType.LOOKUP_GROUPS)
    def _op_lookup_groups(self, h: Dict, _p: bytes) -> Message:
        """Fetch the group table and register for its invalidations — the
        table's LOOKUP_DIR.  The mutex serializes the snapshot against a
        SETGROUPS invalidate+apply window, exactly as the dir mutex does
        for §3.4 namespace mutations."""
        with self._groups_mutex:
            with self._lock:
                if h.get("client_id") and h.get("cb_addr"):
                    self._group_watchers[h["client_id"]] = h["cb_addr"]
                return ok({"groups": {str(u): g
                                      for u, g in self._groups.items()},
                           "gver": self._gver})

    @SERVER_OPS.register(MsgType.REVALIDATE)
    def _op_revalidate(self, h: Dict, p: bytes) -> Message:
        return self._op_lookup_dir(h, p)

    @SERVER_OPS.register(MsgType.LOOKUP_TREE)
    def _op_lookup_tree(self, h: Dict, _p: bytes) -> Message:
        """Readdirplus-style bulk namespace fetch (one RPC): BFS over the
        locally-owned subtree rooted at `file_id`, bounded by `depth`,
        returning every visited directory's dentries + 10-byte perm records.

        Directories that cannot be descended here — owned by another host,
        or beyond the depth bound — are returned in `frontier` so the client
        can continue with one more (batched) round per host.  Every visited
        directory registers the requesting client as a watcher, exactly as a
        LOOKUP_DIR would, so §3.4 invalidations keep reaching prefetched
        nodes."""
        root_fid = h["file_id"]
        depth = max(1, min(int(h.get("depth", MAX_TREE_DEPTH)), MAX_TREE_DEPTH))
        client_id, cb_addr = h.get("client_id"), h.get("cb_addr")
        with self._lock:
            if not self._meta[root_fid].is_dir:
                return error(errno.ENOTDIR, "not a directory")
        dirs: List[Dict] = []
        frontier: List[int] = []
        # per-directory lock scope: each visited dir is snapshotted under
        # its own mutex (consistent vs §3.4 mutation windows) + the meta
        # lock, then released — one big LOOKUP_TREE never stalls the whole
        # server for the duration of the walk
        queue: "deque[Tuple[int, int]]" = deque([(root_fid, 0)])
        while queue:
            fid, d = queue.popleft()
            with self._dir_mutex(fid):
                with self._lock:
                    children = self._dirs.get(fid)
                    m = self._meta.get(fid)
                    if children is None or m is None:
                        continue  # directory vanished mid-walk
                    entries = []
                    # (ino, locally-descendable) for dir children, decided
                    # here where the perm is already decoded — the walk loop
                    # below must not re-parse every entry's hex perm
                    subdirs: List[Tuple[int, bool]] = []
                    for e in children.values():
                        rec = {"name": e.name, "ino": e.ino,
                               "perm": e.perm.pack().hex()}
                        if e.layout:
                            rec["layout"] = e.layout
                        if e.acl:
                            rec["acl"] = e.acl
                        entries.append(rec)
                        if e.perm.is_dir:
                            ci = Inode.unpack(e.ino)
                            subdirs.append((e.ino,
                                            ci.host_id == self.host_id
                                            and ci.file_id in self._dirs))
                    perm_hex = m.perm.pack().hex()
                    if client_id and cb_addr:
                        self._watchers.setdefault(fid, {})[client_id] = cb_addr
            dirs.append({"ino": self._inode(fid), "perm": perm_hex,
                         "entries": entries})
            for ino, local in subdirs:
                if local and d + 1 < depth:
                    queue.append((Inode.unpack(ino).file_id, d + 1))
                else:
                    frontier.append(ino)
        hdr = {"dirs": dirs, "frontier": frontier}
        with self._lock:
            if self._gver:
                hdr["gver"] = self._gver
        return ok(hdr)

    # --- data ops --------------------------------------------------------
    def _record_open(self, io_h: Dict) -> None:
        """Deferred step-2 of open(): update the opened-file list (§3.3 b-3)."""
        rec = io_h.get("incomplete_open")
        if rec:
            with self._lock:
                self._opened.setdefault(io_h["file_id"], set()).add(
                    (rec["client_id"], rec["pid"], rec["fd"]))

    @SERVER_OPS.register(MsgType.READ, grants_lease=True)
    def _op_read(self, h: Dict, _p: bytes) -> Message:
        fid, off, ln = h["file_id"], h["offset"], h["length"]
        self._record_open(h)
        with self._file_lock(fid):
            with self._lock:
                m = self._meta[fid]
                m.atime = time.time()
                wseq = m.wseq  # stable: writers hold the file lock we hold
                layout = m.layout
                msize = m.size
                epoch = m.epoch
                # read-lease grant: registration is atomic with the
                # existence check above, and the surrounding file lock
                # serializes it against a writer's revoke+apply window —
                # a lease granted here is either revoked by that writer's
                # fan-out or sees the post-apply data, never neither.
                rec = h.get("lease")
                granted = bool(rec and rec.get("client_id")
                               and rec.get("cb_addr"))
                if granted:
                    # grants are TTL-bounded: stamp the expiry NOW, before
                    # the response leaves — the client clocks its copy from
                    # before it sent the request, so it always stops
                    # serving no later than this entry says it may
                    self._leases.setdefault(fid, {})[rec["client_id"]] = (
                        rec["cb_addr"], time.monotonic() + self.lease_ttl_s)
            if layout is not None:
                # striped file: this (home) host is the coherence authority
                # — size/wseq/lease all come from here in ONE RPC — and it
                # serves the span inline IF it lies entirely in its OWN
                # chunk objects, so a file no larger than one stripe still
                # reads in exactly one critical-path RPC.  A span that
                # crosses onto other hosts returns metadata only: shipping
                # a partial prefix would serialize one host's transfer in
                # front of the client's parallel gather (which fetches
                # home-resident chunks by CHUNK_READ like any other).
                size = msize  # commit-acked size is authoritative
                data = self._read_local_span(fid, layout, off,
                                             min(off + ln, size))
            else:
                # size comes from the backing file itself, under the file
                # lock: race-free against concurrent WRITEs (the old code
                # read m.size unlocked for the eof flag) and correct even
                # when a crash left meta.json behind the fsynced object
                # data.  Clamping the "read to EOF" sentinel (2 GiB) also
                # avoids BufferedReader's ~0.4ms of buffer setup per huge
                # read() call.
                try:
                    with open(self._obj_path(fid), "rb") as f:
                        size = os.fstat(f.fileno()).st_size
                        f.seek(off)
                        data = f.read(min(ln, max(0, size - off)))
                except FileNotFoundError:
                    size, data = 0, b""
        hdr: Dict = {"eof": off + len(data) >= size, "size": size,
                     "wseq": wseq}
        if layout is not None:
            # striped responses advertise the current chunk epoch so a
            # warm client scatters at the right epoch without an extra RPC
            hdr["epoch"] = epoch
        if granted:
            hdr["lease"] = True
            hdr["lease_ttl_ms"] = int(self.lease_ttl_s * 1000)
        return ok(hdr, data)

    def _read_local_span(self, fid: int, layout: Dict, off: int, end: int
                         ) -> bytes:
        """[off, end) when it lies ENTIRELY in local chunk objects; b""
        otherwise (the client gathers cross-host spans itself, including
        the home-resident chunks, so a partial prefix would only be
        re-fetched — and would have cost a wasted multi-MiB disk read
        here).  The all-or-nothing check is pure layout arithmetic: no
        chunk file is opened unless its bytes will be returned.  A short
        local chunk (a hole) also returns b"": the client's fan-out
        zero-fills holes uniformly."""
        if end <= off:
            return b""
        ss, hosts = layout["ss"], layout["hosts"]
        for idx in range(off // ss, (end - 1) // ss + 1):
            if hosts[idx % len(hosts)] != self.host_id:
                return b""
        parts: List[bytes] = []
        pos = off
        while pos < end:
            idx = pos // ss
            lo = pos - idx * ss
            hi = min(end - idx * ss, ss)
            try:
                with open(self._chunk_path(self.host_id, fid, idx), "rb") as f:
                    f.seek(lo)
                    got = f.read(hi - lo)
            except FileNotFoundError:
                got = b""
            if len(got) < hi - lo:
                return b""  # hole: let the gather path zero-fill it
            parts.append(got)
            pos = idx * ss + hi
        # the common single-chunk case returns the read() bytes unCOPIED —
        # multi-MiB memcpys, not RPCs, dominate a striped read once the
        # fan-out overlaps
        if len(parts) == 1:
            return parts[0]
        return b"".join(parts)

    @SERVER_OPS.register(MsgType.WRITE, mutating=True, breaks_lease=True)
    def _op_write(self, h: Dict, p: bytes) -> Message:
        fid, off = h["file_id"], h["offset"]
        with self._lock:
            meta = self._meta.get(fid)
            if meta is None:
                return error(errno.ENOENT, "no such object")
            striped = meta.layout is not None
        self._record_open(h)
        if striped:
            return self._striped_commit(h, fid)
        if h.get("commit") is not None:
            return error(errno.EINVAL, "commit on unstriped file")
        with self._file_lock(fid):
            # revoke-before-apply, the data-plane twin of the §3.4
            # invalidate-watchers-then-apply path: the file lock spans both
            # the recall and the mutation, and READ grants its lease under
            # the same lock, so no lease can slip in between — by the time
            # this WRITE is acked, no client caches the pre-write block.
            self._revoke_leases(fid, exclude_client=h.get("client_id"))
            path = self._obj_path(fid)
            # "wb" fallback is legitimate re-materialization while metadata
            # exists (e.g. object lost in a crash); the unlinked-file case
            # is caught above and re-checked below
            mode = "r+b" if os.path.exists(path) else "wb"
            with open(path, mode) as f:
                if h.get("truncate"):
                    f.truncate(0)
                f.seek(off)
                f.write(p)
                if self.fsync_policy == "mutating":
                    f.flush()
                    os.fsync(f.fileno())
            with self._lock:
                m = self._meta.get(fid)
                if m is None:
                    # unlinked while we were writing: remove the object we
                    # just (re-)materialized rather than leak an orphan
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
                    return error(errno.ENOENT, "unlinked during write")
                # an empty write is a no-op for size (seek past EOF without
                # bytes extends nothing); O_TRUNC still applies
                base = 0 if h.get("truncate") else m.size
                m.size = max(base, off + len(p)) if p else base
                m.mtime = time.time()
                m.wseq += 1
                size, wseq = m.size, m.wseq
                # data record AFTER the bytes hit disk, meta record inside
                # this lock hold — both orderings the snapshot reset needs
                self._journal({"op": "odata", "fid": fid, "off": off,
                               **({"trunc": True} if h.get("truncate")
                                  else {})}, p)
                self._jmeta(fid)
        return ok({"written": len(p), "size": size, "wseq": wseq})

    def _striped_commit(self, h: Dict, fid: int) -> Message:
        """WRITE on a striped file: the client already scattered the bytes
        to the stripe hosts' chunk objects (CHUNK_WRITE fan-out); this
        request publishes the result — under the same file lock and with
        the same revoke-before-apply lease recall as an ordinary WRITE, so
        the page-cache coherence argument is untouched.  ``commit`` is the
        list of [offset, length] extents that were scattered.  A striped
        file never defers O_TRUNC onto its first WRITE: the client sends
        an explicit TRUNCATE first (the home host must clip chunks on the
        stripe hosts before new data lands, or reclaimed ranges could
        resurface as garbage in later holes)."""
        commit = h.get("commit")
        if commit is None:
            return error(errno.EINVAL,
                         "payload WRITE on striped file (scatter + commit)")
        with self._file_lock(fid):
            with self._lock:
                m = self._meta.get(fid)
                if m is None:
                    return error(errno.ENOENT, "unlinked during write")
                # epoch gate, BEFORE the lease recall: a commit whose
                # scatter predates the current chunk epoch would publish a
                # size the chunk store no longer backs (a truncate clipped
                # the scattered bytes in between) — refuse it and hand back
                # the current epoch so the writer re-scatters, instead of
                # acking bytes that read back as zeros.  Rejecting before
                # the revoke also keeps a doomed commit from thrashing
                # every reader's cache for nothing.
                if h.get("epoch", 0) != m.epoch:
                    self.epoch_rejects += 1
                    e = error(EPOCHSTALE,
                              f"commit epoch {h.get('epoch', 0)} != "
                              f"{m.epoch}")
                    e.header["epoch"] = m.epoch
                    return e
            self._revoke_leases(fid, exclude_client=h.get("client_id"))
            with self._lock:
                m = self._meta.get(fid)
                if m is None:
                    return error(errno.ENOENT, "unlinked during write")
                # zero-length extents don't extend: write(fd, b"") at an
                # offset past EOF is a POSIX no-op, not a size change
                end = max((o + ln for o, ln in commit if ln > 0), default=0)
                m.size = max(m.size, end)
                m.mtime = time.time()
                m.wseq += 1
                size, wseq, epoch = m.size, m.wseq, m.epoch
                # the scattered chunk bytes were journaled by each stripe
                # host's CHUNK_WRITE; the commit only publishes size/mtime
                self._jmeta(fid)
        return ok({"written": sum(ln for _, ln in commit), "size": size,
                   "wseq": wseq, "epoch": epoch})

    @SERVER_OPS.register(MsgType.TRUNCATE, mutating=True, breaks_lease=True)
    def _op_truncate(self, h: Dict, _p: bytes) -> Message:
        fid = h["file_id"]
        with self._lock:
            meta = self._meta.get(fid)
            if meta is None:
                return error(errno.ENOENT, "no such object")
            layout = meta.layout
        self._record_open(h)
        with self._file_lock(fid):
            # same revoke-before-apply ordering as _op_write
            self._revoke_leases(fid, exclude_client=h.get("client_id"))
            if layout is not None:
                # home-host orchestration: physically clip/delete chunk
                # objects on their stripe hosts under the file lock, BEFORE
                # the new size is published and the truncate acked — a
                # later extend-write must find zeros in the reclaimed
                # range, not resurrected pre-truncate bytes.  The size the
                # plan covers is read UNDER the file lock: a commit racing
                # in before we acquired it may have grown the file, and a
                # plan built from a stale snapshot would leave its chunks
                # unclipped (resurrectable).
                with self._lock:
                    m = self._meta.get(fid)
                    old_size = m.size if m is not None else 0
                    shrink = m is not None and h["size"] < old_size
                    if shrink:
                        # a shrink destroys committed chunk bytes: bump the
                        # chunk epoch (still under the file lock) so every
                        # in-flight scatter issued under the old epoch is
                        # self-invalidating — stripe hosts refuse it once
                        # they see the new epoch, and its commit dies at
                        # the epoch gate above.  Bumped BEFORE the fan-out
                        # so no clip can race a new-epoch scatter: clients
                        # can only learn the new epoch from a response
                        # generated after this lock section completes.
                        m.epoch += 1
                        epoch = m.epoch
                plan = self._chunk_trunc_plan(layout, old_size, h["size"])
                if shrink:
                    # carry the new epoch to EVERY stripe host — including
                    # those with nothing to clip — so their latches refuse
                    # old-epoch scatters from here on
                    for host in set(layout["hosts"]):
                        plan.setdefault(host, [])
                failed = self._fanout_chunks({
                    host: Message(MsgType.CHUNK_TRUNC,
                                  {"home": self.host_id, "file_id": fid,
                                   "ops": ops,
                                   **({"epoch": epoch} if shrink else {})})
                    for host, ops in plan.items()})
                if failed:
                    # unlike unlink's reap (dead file_id, orphans are only
                    # garbage) an unclipped chunk on a LIVE file would
                    # resurface as data under a later extend — refuse the
                    # truncate rather than publish a size the chunk store
                    # contradicts (partial clips are holes: they read
                    # zeros, same as a crash mid-truncate; the epoch bump
                    # above stands, which only forces retries, never loss)
                    return error(errno.EIO,
                                 f"{len(failed)} stripe host(s) failed to clip")
            else:
                path = self._obj_path(fid)
                # mirror _op_write: re-materialize a crash-lost object while
                # metadata exists; the unlinked-race case is handled by the
                # post-mutation meta re-check below, never by leaking an
                # orphan
                mode = "r+b" if os.path.exists(path) else "wb"
                with open(path, mode) as f:
                    f.truncate(h["size"])
            with self._lock:
                m = self._meta.get(fid)
                if m is None:
                    if layout is None:
                        try:
                            os.unlink(self._obj_path(fid))
                        except FileNotFoundError:
                            pass
                    return error(errno.ENOENT, "unlinked during truncate")
                m.size = h["size"]
                m.mtime = time.time()
                m.wseq += 1
                wseq = m.wseq
                if layout is None:
                    self._journal({"op": "otrunc", "fid": fid,
                                   "size": h["size"]})
                self._jmeta(fid)
                hdr = {"wseq": wseq}
                if layout is not None:
                    hdr["epoch"] = m.epoch
        return ok(hdr)

    @SERVER_OPS.register(MsgType.FSYNC, barrier=True)
    def _op_fsync(self, h: Dict, _p: bytes) -> Message:
        """Durability barrier for one file: fsync the backing object and
        persist the metadata blob, regardless of the server's fsync_policy.
        Every WRITE/TRUNCATE applied before this request was dispatched is
        therefore stable before the client's fsync() returns — the ordering
        contract the client-side write-behind pipeline builds on."""
        fid = h["file_id"]
        with self._lock:
            meta = self._meta.get(fid)
            if meta is None:
                return error(errno.ENOENT, "no such object")
            layout, size = meta.layout, meta.size
        self._record_open(h)
        with self._file_lock(fid):
            if layout is not None:
                # striped: the barrier must cover every chunk object, so
                # the home host fans CHUNK_FSYNCs out to the stripe hosts
                # before persisting its own metadata and acking.  Unlike
                # the truncate/unlink reaps this is NOT best-effort: an
                # unreachable stripe host means the durability contract
                # cannot be honored, and the client must hear that.
                failed = self._fanout_chunks({
                    host: Message(MsgType.CHUNK_FSYNC,
                                  {"home": self.host_id, "file_id": fid,
                                   "indices": idxs})
                    for host, idxs in
                    self._chunk_indices_by_host(layout, size).items()})
                if failed:
                    return error(errno.EIO,
                                 f"{len(failed)} stripe host(s) failed to fsync")
            else:
                try:
                    with open(self._obj_path(fid), "rb") as f:
                        os.fsync(f.fileno())
                except FileNotFoundError:
                    pass  # zero-write file: only metadata to make durable
        with self._lock:
            if fid not in self._meta:
                return error(errno.ENOENT, "unlinked during fsync")
            self._persist_now()
        return ok()

    @SERVER_OPS.register(MsgType.CLOSE)
    def _op_close(self, h: Dict, _p: bytes) -> Message:
        """Wrap-up (async on the client side): drop from the opened-file list."""
        with self._lock:
            s = self._opened.get(h["file_id"])
            if s:
                s.discard((h["client_id"], h["pid"], h["fd"]))
                if not s:
                    del self._opened[h["file_id"]]
        return ok()

    # --- cross-host namespace ops (decentralized placement) -------------
    @SERVER_OPS.register(MsgType.MKNOD_OBJ, mutating=True)
    def _op_mknod_obj(self, h: Dict, _p: bytes) -> Message:
        """Allocate a file/dir object on THIS data host; the dentry will be
        linked into the parent directory's namespace host separately."""
        is_dir = bool(h["is_dir"])
        perm = PermRecord((S_IFDIR if is_dir else S_IFREG) | (h["mode"] & 0o777),
                          h["uid"], h["gid"])
        layout = None if is_dir else h.get("layout")
        with self._lock:
            fid = self._alloc(FileMeta(perm=perm, is_dir=is_dir,
                                       ctime=time.time(), mtime=time.time(),
                                       layout=layout))
            if is_dir:
                self._dirs[fid] = {}
            elif layout is None:
                open(self._obj_path(fid), "wb").close()
            ino = self._inode(fid)
            self._meta[fid].xattrs["buffet.ino"] = str(ino)
            self._persist()
            self._jmeta(fid)
            if is_dir:
                self._journal({"op": "dir", "fid": fid})
            self._journal({"op": "next_fid", "v": self._next_file_id})
        hdr = {"ino": ino, "perm": perm.pack().hex()}
        if layout:
            hdr["layout"] = layout
        return ok(hdr)

    @SERVER_OPS.register(MsgType.LINK_DENTRY, mutating=True)
    def _op_link_dentry(self, h: Dict, _p: bytes) -> Message:
        parent, name = h["parent"], h["name"]
        perm = PermRecord.unpack(bytes.fromhex(h["perm"]))

        def check() -> Optional[Message]:
            if name in self._dirs[parent]:
                return error(errno.EEXIST, name)
            return None

        def apply() -> Message:
            self._dirs[parent][name] = DirEntry(name, h["ino"], perm,
                                                layout=h.get("layout"),
                                                acl=h.get("acl"))
            self._persist()
            self._journal({"op": "dentry", "dir": parent, "name": name,
                           "e": self._entry_rec(self._dirs[parent][name])})
            return ok()

        return self._two_phase(parent, [name], check, apply,
                               exclude_client=h.get("client_id"))

    # --- chunk store (striped data plane) --------------------------------
    # Chunk verbs are BLIND storage: no FileMeta, no leases, no wseq — the
    # file's home host is the single coherence authority, and every chunk
    # mutation is ordered by the home host's file lock (clients commit a
    # scatter at the home host, the home host fans out truncate/unlink/
    # fsync).  That is what lets the page-cache invariants survive
    # striping unchanged.

    @SERVER_OPS.register(MsgType.CHUNK_READ)
    def _op_chunk_read(self, h: Dict, _p: bytes) -> Message:
        home, fid, idx = h["home"], h["file_id"], h["index"]
        off, ln = h["offset"], h["length"]
        with self._chunk_lock(home, fid, idx):
            try:
                with open(self._chunk_path(home, fid, idx), "rb") as f:
                    f.seek(off)
                    data = f.read(ln)
            except FileNotFoundError:
                data = b""  # absent chunk == hole: reads as zeros client-side
        return ok({"index": idx}, data)

    @SERVER_OPS.register(MsgType.CHUNK_WRITE, mutating=True)
    def _op_chunk_write(self, h: Dict, p: bytes) -> Message:
        home, fid, idx = h["home"], h["file_id"], h["index"]
        epoch = h.get("epoch", 0)
        path = self._chunk_path(home, fid, idx)
        # the latch check lives INSIDE the chunk lock: a clip latches the
        # new epoch (under self._lock) before taking chunk locks, so a
        # scatter that passes this check while holding the chunk lock is
        # ordered wholly before the clip — checked outside it, a clip
        # could slip between check and write and the stale bytes would
        # land back in the just-clipped chunk
        with self._chunk_lock(home, fid, idx):
            with self._lock:
                latched = self._chunk_epochs.get((home, fid), 0)
                if epoch < latched:
                    # a truncate's clip fan-out (or a scrub clip) already
                    # carried a newer epoch through here: this scatter's
                    # bytes are pre-clip leftovers that must never land —
                    # refusing them is what keeps a failed/raced scatter
                    # from leaving garbage beyond the committed size in
                    # the first place
                    self.epoch_rejects += 1
                else:
                    self._chunk_epochs[(home, fid)] = max(latched, epoch)
            if epoch < latched:
                e = error(EPOCHSTALE, f"scatter epoch {epoch} < {latched}")
                e.header["epoch"] = latched
                return e
            mode = "r+b" if os.path.exists(path) else "wb"
            with open(path, mode) as f:
                f.seek(h["offset"])
                f.write(p)
                if self.fsync_policy == "mutating":
                    f.flush()
                    os.fsync(f.fileno())
        # every host replicates ITS OWN object store: a chunk accepted here
        # ships to this host's standby, so a promoted replacement can serve
        # CHUNK_READs for the chunks that died with this disk
        self._journal({"op": "cdata", "home": home, "fid": fid, "idx": idx,
                       "off": h["offset"]}, p)
        return ok({"written": len(p)})

    @SERVER_OPS.register(MsgType.CHUNK_TRUNC, mutating=True)
    def _op_chunk_trunc(self, h: Dict, _p: bytes) -> Message:
        """Clip/delete chunk objects per the home host's truncate plan:
        ``ops`` is a list of [index, new_len] with new_len < 0 => delete.
        An absent chunk is already all-zeros at any length — skip it.  When
        the home bumped the chunk epoch (shrinking truncate, scrub clip)
        the message carries it; latch it FIRST so no old-epoch scatter can
        land after (or while) we clip."""
        home, fid = h["home"], h["file_id"]
        epoch = h.get("epoch")
        if epoch is not None:
            with self._lock:
                key = (home, fid)
                self._chunk_epochs[key] = max(self._chunk_epochs.get(key, 0),
                                              epoch)
        for idx, new_len in h["ops"]:
            path = self._chunk_path(home, fid, idx)
            with self._chunk_lock(home, fid, idx):
                try:
                    if new_len < 0:
                        os.unlink(path)
                    elif os.path.exists(path):
                        with open(path, "r+b") as f:
                            f.truncate(new_len)
                except FileNotFoundError:
                    pass
        self._journal({"op": "ctrunc", "home": home, "fid": fid,
                       "ops": h["ops"]})
        return ok()

    @SERVER_OPS.register(MsgType.CHUNK_UNLINK, mutating=True)
    def _op_chunk_unlink(self, h: Dict, _p: bytes) -> Message:
        home, fid = h["home"], h["file_id"]
        reaped = 0
        for idx in h["indices"]:
            with self._chunk_lock(home, fid, idx):
                try:
                    os.unlink(self._chunk_path(home, fid, idx))
                    reaped += 1
                except FileNotFoundError:
                    pass
        with self._lock:
            # dead file_ids are never reused: the epoch latch has nothing
            # left to guard, and keeping it would leak one entry per unlink
            self._chunk_epochs.pop((home, fid), None)
        self._journal({"op": "cdel", "home": home, "fid": fid,
                       "indices": h["indices"]})
        # how many chunk files actually existed: lets a scrub retry of a
        # failed reap count true orphans exactly once cluster-wide
        return ok({"reaped": reaped})

    @SERVER_OPS.register(MsgType.CHUNK_FSYNC, barrier=True)
    def _op_chunk_fsync(self, h: Dict, _p: bytes) -> Message:
        home, fid = h["home"], h["file_id"]
        for idx in h["indices"]:
            with self._chunk_lock(home, fid, idx):
                try:
                    with open(self._chunk_path(home, fid, idx), "rb") as f:
                        os.fsync(f.fileno())
                except FileNotFoundError:
                    pass  # hole chunk: nothing to make durable
        return ok()

    # --- scrubber: reconcile the chunk store against home-host layouts ---
    # Chunk objects are blind storage, so two failure shapes accumulate
    # silently: orphans for dead file_ids (an unlink reap that could not
    # reach this host) and bytes beyond the committed size (a scatter whose
    # commit never happened — client crash, failed write — which a later
    # extend would surface where a hole must read zeros).  The scrubber is
    # the reconciliation loop that turns both from documented caveats into
    # enforced invariants: each host walks its OWN chunk store and asks
    # every file's HOME host (SCRUB_CLIP) whether the file is dead or what
    # each chunk's allowed length is.  The home answers — and performs any
    # clip itself, under the file lock with an epoch bump — so a scrub can
    # never race a live scatter→commit into acknowledged-byte loss.

    def _scan_chunk_store(self) -> Dict[Tuple[int, int],
                                        List[Tuple[int, int]]]:
        """This host's chunk objects: (home, file_id) -> [(index, length)]."""
        found: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for name in os.listdir(self._objs):
            if not name.startswith("c"):
                continue  # a whole-file object, not a chunk
            try:
                home_s, fid_s, idx_s = name[1:].split("_")
                home, fid, idx = int(home_s, 16), int(fid_s, 16), int(idx_s, 16)
            except ValueError:
                continue
            try:
                clen = os.path.getsize(os.path.join(self._objs, name))
            except OSError:
                continue  # reaped between listdir and stat
            found.setdefault((home, fid), []).append((idx, clen))
        return found

    def _request_host(self, host: int, msg: Message) -> Message:
        """One server-to-server request (local dispatch when the target is
        this host); unreachability comes back as an ERROR message, never
        an exception — scrub phases treat it as retry-next-pass."""
        if host == self.host_id:
            return SERVER_OPS.dispatch(self, msg)
        if self.peers is None:
            return error(errno.EHOSTUNREACH, "no peer config")
        try:
            return self.transport.request(self.peers.addr(host), msg,
                                          critical=True)
        except Exception as e:
            return error(errno.EHOSTUNREACH, str(e))

    def scrub_pass(self) -> Dict[str, int]:
        """One scrub pass.  Two phases: (1) as a HOME host, retry every
        recorded failed unlink reap (draining `chunk_reap_failures` even
        for stripe hosts that hold no chunk file and so would never ask
        about the dead fid themselves); (2) as a STRIPE host, reconcile
        this host's own chunk store against home-host layouts.  Returns
        this pass's counts: orphans_reaped / chunks_clipped /
        bytes_clipped, plus scrub_errors for hosts that could not be
        reached (their work is left alone and retried next pass)."""
        counts = {"orphans_reaped": 0, "chunks_clipped": 0,
                  "bytes_clipped": 0, "scrub_errors": 0,
                  "under_replicated": 0, "repaired_chunks": 0}
        with self._lock:
            pending = dict(self._reap_pending)
        for (host, fid), idxs in sorted(pending.items()):
            resp = self._request_host(host, Message(MsgType.CHUNK_UNLINK, {
                "home": self.host_id, "file_id": fid, "indices": idxs}))
            if resp.type is MsgType.ERROR:
                counts["scrub_errors"] += 1  # still down: debt stands
                continue
            counts["orphans_reaped"] += resp.header.get("reaped", 0)
            with self._lock:
                self._reap_pending.pop((host, fid), None)
        for (home, fid), chunks in sorted(self._scan_chunk_store().items()):
            resp = self._request_host(home, Message(MsgType.SCRUB_CLIP, {
                "file_id": fid, "requester": self.host_id,
                "chunks": [[idx, clen] for idx, clen in sorted(chunks)]}))
            if resp.type is MsgType.ERROR:
                counts["scrub_errors"] += 1
                continue
            if resp.header.get("dead"):
                for idx, _ in chunks:
                    with self._chunk_lock(home, fid, idx):
                        try:
                            os.unlink(self._chunk_path(home, fid, idx))
                        except FileNotFoundError:
                            continue
                    counts["orphans_reaped"] += 1
                with self._lock:
                    self._chunk_epochs.pop((home, fid), None)
                self._journal({"op": "cdel", "home": home, "fid": fid,
                               "indices": [idx for idx, _ in chunks]})
            else:
                # any clipping already happened: the home fanned a
                # CHUNK_TRUNC back at us under its file lock (with an
                # epoch bump), so by the time this response arrives the
                # trailing bytes are gone and no stale scatter can redo them
                counts["chunks_clipped"] += resp.header.get("chunks_clipped", 0)
                counts["bytes_clipped"] += resp.header.get("bytes_clipped", 0)
                layout = resp.header.get("layout")
                if layout is not None:
                    self._repair_replicas(home, fid, layout,
                                          resp.header.get("size", 0),
                                          resp.header.get("epoch", 0),
                                          chunks, counts)
        # standing health counters: the gauge is THIS pass's missing-copy
        # count (a healthy cluster converges it to 0), repairs accumulate
        with self._lock:
            self.under_replicated = counts["under_replicated"]
            self.repaired_chunks += counts["repaired_chunks"]
        return counts

    def _repair_replicas(self, home: int, fid: int, layout: Dict,
                         size: int, epoch: int,
                         chunks: List[Tuple[int, int]],
                         counts: Dict[str, int]) -> None:
        """Re-replicate missing/divergent copies of chunks THIS host holds.
        For each local chunk, CHUNK_STAT the other members of its replica
        set (length + crc32 of our copy's prefix) and push our copy
        (CHUNK_WRITE at the epoch the home just vouched for) to peers
        holding less than we do.  Authority rules:

          * a peer SHORTER than us is under-replicated, full stop —
            committed writes only grow a chunk within an epoch (truncates
            bump it and clip everywhere), so the longer copy is the newer
            one and is pushed unconditionally;
          * a peer of EQUAL-OR-GREATER length whose prefix checksum
            diverges from ours is ambiguous: we push only when our bytes
            agree with a write quorum of the replica set (ourselves + W-1
            checksum-matching peers) — a stale rejoined host can never
            out-vote the surviving majority and smear its bytes back.

        The push is fenced twice: the bytes are re-read AFTER the home's
        clip fan-out (so they never exceed the committed size), and the
        receiving host's epoch latch refuses the write if a newer truncate
        passed it in the meantime — repair can delay convergence, never
        resurrect clipped bytes."""
        ss = layout["ss"]
        for idx, _ in sorted(chunks):
            replicas = chunk_hosts(layout, idx)
            if self.host_id not in replicas:
                continue  # not ours to guard (layout moved under us)
            allowed = min(max(size - idx * ss, 0), ss)
            if allowed <= 0:
                continue
            with self._chunk_lock(home, fid, idx):
                try:
                    with open(self._chunk_path(home, fid, idx), "rb") as f:
                        data = f.read(allowed)
                except OSError:
                    continue  # reaped since the scan: nothing to push
            if not data:
                continue
            csum = zlib.crc32(data)
            short: List[int] = []
            divergent: List[int] = []
            matching = 0
            for peer in replicas:
                if peer == self.host_id:
                    continue
                resp = self._request_host(peer, Message(MsgType.CHUNK_STAT, {
                    "home": home, "file_id": fid, "index": idx,
                    "length": len(data)}))
                if resp.type is MsgType.ERROR:
                    counts["scrub_errors"] += 1
                elif resp.header.get("clen", -1) < len(data):
                    short.append(peer)
                elif resp.header.get("csum") != csum:
                    divergent.append(peer)
                else:
                    matching += 1
            quorum = len(replicas) // 2 + 1
            if divergent and 1 + matching < quorum:
                # our bytes lack a quorum behind them: we may BE the stale
                # copy — flag the divergence, let the majority's pass fix it
                counts["under_replicated"] += len(divergent)
                divergent = []
            for peer in short + divergent:
                counts["under_replicated"] += 1
                resp = self._request_host(peer, Message(
                    MsgType.CHUNK_WRITE,
                    {"home": home, "file_id": fid, "index": idx,
                     "offset": 0, "epoch": epoch}, data))
                if resp.type is MsgType.ERROR:
                    # EPOCHSTALE (a truncate won the race) or unreachable:
                    # leave it for the next pass, the gauge stays nonzero
                    counts["scrub_errors"] += 1
                else:
                    counts["repaired_chunks"] += 1

    @SERVER_OPS.register(MsgType.SCRUB, mutating=True)
    def _op_scrub(self, h: Dict, _p: bytes) -> Message:
        """On-demand scrub: run one pass now and report its counts plus
        this host's standing epoch-reject / reap-debt counters."""
        counts = self.scrub_pass()
        counts["epoch_rejects"] = self.epoch_rejects
        counts["chunk_reap_failures"] = self.chunk_reap_failures
        counts["scrub_failures"] = self.scrub_failures
        return ok(counts)

    @SERVER_OPS.register(MsgType.SCRUB_CLIP, mutating=True)
    def _op_scrub_clip(self, h: Dict, _p: bytes) -> Message:
        """Home-host half of a scrub: a stripe host reports the chunks it
        holds for one of OUR files; answer dead (reap them) or clip the
        overhang ourselves.  The clip runs under the file lock with a
        chunk-epoch bump and a CHUNK_TRUNC fan-out back to the requester —
        exactly a truncate's discipline — so an in-flight scatter→commit
        racing the scrub either lands wholly before the clip plan is sized
        (its bytes are committed, the plan spares them) or dies EPOCHSTALE
        and retries.  Without the bump, the scrubber itself would be the
        truncate-vs-scatter race it exists to clean up after."""
        fid, requester = h["file_id"], h["requester"]
        with self._lock:
            m = self._meta.get(fid)
            dead = m is None or m.layout is None
        if dead:
            # unlinked (or never striped: a chunk for an unstriped file is
            # garbage by construction) — tell the requester to reap, and
            # retire the matching reap-failure debt
            with self._lock:
                self._reap_pending.pop((requester, fid), None)
            return ok({"dead": True})
        with self._file_lock(fid):
            with self._lock:
                m = self._meta.get(fid)
                if m is None or m.layout is None:
                    self._reap_pending.pop((requester, fid), None)
                    return ok({"dead": True})
                size, ss = m.size, m.layout["ss"]
                layout, cur_epoch = m.layout, m.epoch
                ops: List[List[int]] = []
                bytes_clipped = 0
                for idx, clen in h["chunks"]:
                    allowed = min(max(size - idx * ss, 0), ss)
                    if clen > allowed:
                        ops.append([idx, -1 if allowed == 0 else allowed])
                        bytes_clipped += clen - allowed
                if ops:
                    m.epoch += 1
                    epoch = cur_epoch = m.epoch
            if ops:
                failed = self._fanout_chunks({requester: Message(
                    MsgType.CHUNK_TRUNC,
                    {"home": self.host_id, "file_id": fid, "ops": ops,
                     "epoch": epoch})})
                if failed:
                    return error(errno.EIO, "scrub clip fan-out failed")
                with self._lock:
                    self._persist()  # the epoch bump persists like a size
                    self._jmeta(fid)
        hdr = {"dead": False, "chunks_clipped": len(ops),
               "bytes_clipped": bytes_clipped}
        if layout.get("r", 1) > 1:
            # replicated layout: hand the requester everything its repair
            # scan needs — the replica sets, the committed size (so a hole
            # is never "repaired" into existence) and the current chunk
            # epoch (so a repair push into a host that saw a newer
            # truncate dies EPOCHSTALE instead of resurrecting clipped
            # bytes)
            hdr["layout"] = layout
            hdr["size"] = size
            hdr["epoch"] = cur_epoch
        return ok(hdr)

    # NOTE: the Lustre baseline verbs (OPEN_RECORD, READ_INLINE) register
    # into the same SERVER_OPS registry from repro_torch.core.baselines — the
    # baseline protocol lives with the baselines, not inside BServer.

    @SERVER_OPS.register(MsgType.PING)
    def _op_ping(self, h: Dict, _p: bytes) -> Message:
        return ok({"host_id": self.host_id, "version": self.version})

    @SERVER_OPS.register(MsgType.HEARTBEAT)
    def _op_heartbeat(self, h: Dict, _p: bytes) -> Message:
        """Liveness probe (answered regardless of the sender's incarnation
        belief — see handle()).  With {"view": true} the response carries
        this server's per-peer last-seen ages in seconds, the raw material
        of the monitor's quorum vote."""
        hdr: Dict = {"host_id": self.host_id, "version": self.version}
        if h.get("view"):
            now = time.monotonic()
            hdr["hb_seen"] = {str(p): now - t
                              for p, t in dict(self._hb_seen).items()}
        return ok(hdr)

    @SERVER_OPS.register(MsgType.CHUNK_STAT)
    def _op_chunk_stat(self, h: Dict, _p: bytes) -> Message:
        """Blind storage probe: the byte length this host holds for one
        chunk object, -1 when absent (a hole or a missing replica copy —
        the caller knows which, because it holds its own copy).  With
        "length" N in the request the response also carries "csum", the
        crc32 of the first min(clen, N) bytes, so the scrubber can tell a
        divergent same-length copy from a healthy one."""
        home, fid, idx = h["home"], h["file_id"], h["index"]
        hdr: Dict = {"index": idx}
        path = self._chunk_path(home, fid, idx)
        want = h.get("length")
        with self._chunk_lock(home, fid, idx):
            try:
                hdr["clen"] = os.path.getsize(path)
                with open(path, "rb") as f:
                    hdr["csum"] = zlib.crc32(
                        f.read() if want is None else f.read(want))
            except OSError:
                hdr["clen"] = -1
                hdr.pop("csum", None)
        return ok(hdr)

    # --- introspection ---------------------------------------------------
    def opened_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._opened.values())

    def watcher_count(self) -> int:
        with self._lock:
            return sum(len(w) for w in self._watchers.values())

    def lease_count(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._leases.values())

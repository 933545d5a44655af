"""BAgent — the BuffetFS client agent (paper §3.1, §3.3).

One BAgent per client process.  It maintains:

* an **incomplete directory tree** whose nodes carry the 10-byte permission
  records of *all children* of every fetched directory — so `open()` runs its
  permission checks entirely locally, with zero RPCs when the parent chain is
  cached, and at most one LOOKUP_DIR per previously-unseen directory;
* a **fd table** with per-process context (pid, uid/gid credentials);
* the **incomplete-open** deferral: the server-side half of `open()` (updating
  the opened-file list) rides on the first READ/WRITE for that fd (§3.3 b-2);
* **async close()**: the CLOSE RPC leaves on a background thread (§3.3);
* the **invalidation callback** endpoint used by servers before they apply
  permission changes (§3.4), giving strong consistency;
* **ESTALE recovery**: if a server restarted, its incarnation version no
  longer matches; the agent re-learns the version via the cluster config and
  retries (§3.2 version segment);
* an optional **write-behind pipeline** (``write_behind=True``): write()
  appends into a per-handle dirty buffer and returns with ZERO critical-path
  RPCs; per-host flusher threads coalesce adjacent extents, pack multi-file
  WRITE sub-messages into BATCH envelopes and pipeline them off the critical
  path, under a bounded dirty-bytes budget that applies backpressure.  Flush
  errors are latched per handle and re-raised at the next write()/fsync()/
  close() (CannyFS-style optimistic completion); fsync() is the durability
  barrier (drain + server-side FSYNC), and reads/unlinks drain the affected
  file first so ordering and read-your-writes are preserved;
* an optional **lease-consistent page cache** (``read_cache=True``): READ
  responses fill a bounded per-agent LRU block cache and carry a read-lease
  grant; warm read()/pread() are then served locally with ZERO critical-path
  RPCs.  The server recalls leases over the callback channel
  (REVOKE_LEASE) before acking any other client's write/truncate/unlink —
  the data-plane twin of the §3.4 namespace invalidations — and a
  revocation-generation check makes a READ response that crossed a revoke
  on the wire uncacheable, so a stale block can never be served.  Under
  write-behind, locally-buffered dirty extents SHADOW cached clean blocks
  (read-your-writes without draining), and completed flushes patch the
  cache in place.
"""
from __future__ import annotations

import errno
import itertools
import queue
import threading
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cluster import BuffetCluster, ClusterConfig
from .inode import Inode
from .perms import (Credentials, FSError, O_CREAT, PermRecord, R_OK, W_OK,
                    X_OK, access_ok, err, flags_to_access, normalize_groups,
                    validate_acl, O_TRUNC)
from .service import MAX_TREE_DEPTH
from .transport import Transport
from .wire import (EPOCHSTALE, Message, MsgType, RpcStats, chunk_hosts,
                   error as wire_error, ok, pack_batch, stripe_spans,
                   unpack_batch)

_agent_counter = itertools.count()

# RPC failures that mean "the server may be down or mid-failover" rather
# than "the operation is wrong": worth retrying with backoff, because an
# admin promote() may re-point the cluster config at a standby meanwhile.
_TRANSIENT_ERRNOS = frozenset({errno.ENOTCONN, errno.ECONNREFUSED,
                               errno.ETIMEDOUT, errno.EHOSTUNREACH})

DEFAULT_BATCH = 256  # sub-messages per BATCH frame on the bulk paths

# write-behind defaults: total unflushed bytes an agent may buffer before
# write() blocks (backpressure), and the byte size at which the flusher
# starts a new BATCH envelope so one giant flush doesn't head-of-line-block
# a host's pipeline
DEFAULT_DIRTY_BUDGET = 8 * 1024 * 1024
MAX_FLUSH_ENVELOPE_BYTES = 4 * 1024 * 1024

# read-cache defaults: fixed block granularity and the total byte budget one
# agent may pin across all files (LRU-evicted beyond it)
DEFAULT_CACHE_BLOCK = 64 * 1024
DEFAULT_CACHE_BUDGET = 32 * 1024 * 1024

# readahead default: how far past the current offset the sequential-read
# detector prefetches into the page cache (clipped to EOF)
DEFAULT_READAHEAD_WINDOW = 512 * 1024

# scatter/commit rounds re-run when a concurrent truncate moves the chunk
# epoch mid-write: each retry means ANOTHER truncate interleaved, so more
# than a handful signals pathological contention, not a transient race
_EPOCH_RETRIES = 8

# hedged-read default: how long a replicated (r>1) gather waits on the
# primary replica before duplicating the outstanding CHUNK_READs to the
# next one — a p99-ish bound for a healthy in-proc/LAN chunk fetch, so a
# straggling stripe host costs one extra RPC instead of its whole stall.
# BAgent(hedge_delay_s=...) overrides it per agent.
DEFAULT_HEDGE_DELAY_S = 0.05


def _chunks(items: List, n: int) -> List[List]:
    n = max(1, n)  # a non-positive batch size must not silently drop work
    return [items[i : i + n] for i in range(0, len(items), n)]


def _ino_key(ino: int) -> Tuple[int, int]:
    """Version-insensitive identity of an inode (restarts bump versions)."""
    i = Inode.unpack(ino)
    return (i.host_id, i.file_id)


class TreeNode:
    """Node of the client-cached partial directory tree."""

    __slots__ = ("name", "ino", "perm", "children", "valid", "parent",
                 "layout", "acl")

    def __init__(self, name: str, ino: int, perm: PermRecord,
                 parent: Optional["TreeNode"] = None,
                 layout: Optional[Dict] = None,
                 acl: Optional[List] = None) -> None:
        self.name = name
        self.ino = ino
        self.perm = perm
        self.parent = parent
        # stripe layout from the dentry (None => unstriped): like the
        # 10-byte perm record, it lets the client plan a striped
        # scatter-gather with zero metadata RPCs
        self.layout = layout
        # per-file ACL from the dentry (None => mode bits alone): the rich
        # grants are evaluated client-side too, still 0 RPCs warm
        self.acl = acl
        # None => directory data not fetched (or not a directory)
        self.children: Optional[Dict[str, TreeNode]] = None
        self.valid = True  # False => server invalidated; must REVALIDATE

    def path(self) -> str:
        parts = []
        node: Optional[TreeNode] = self
        while node is not None and node.parent is not None:
            parts.append(node.name)
            node = node.parent
        return "/" + "/".join(reversed(parts))


class _Extent:
    """One contiguous run of buffered write-behind data."""

    __slots__ = ("offset", "data")

    def __init__(self, offset: int, data: bytearray) -> None:
        self.offset = offset
        self.data = data

    @property
    def end(self) -> int:
        return self.offset + len(self.data)


def _coalesce(extents: List[_Extent]) -> List[_Extent]:
    """Merge adjacent/overlapping extents (later data wins on overlap)."""
    if len(extents) <= 1:
        return extents
    out: List[_Extent] = []
    for e in sorted(extents, key=lambda x: x.offset):
        if out and e.offset <= out[-1].end:
            last = out[-1]
            # splice so later data wins but any tail beyond the new extent
            # survives (bytearray slice assignment grows/replaces as needed)
            last.data[e.offset - last.offset : e.end - last.offset] = e.data
        else:
            out.append(e)
    return out


def _subtract_extents(stalled: List[_Extent],
                      newer: List[_Extent]) -> List[_Extent]:
    """Punch out of ``stalled`` every byte range covered by ``newer``.
    Used when restaging extents from a retryable flush failure back into
    the dirty list: the stalled bytes are OLDER than anything buffered
    since, and _coalesce's later-splices-over-earlier rule would let them
    resurface over newer data unless the overlap is removed first."""
    out: List[_Extent] = []
    for e in stalled:
        pieces: List[Tuple[int, bytearray]] = [(e.offset, e.data)]
        for d in newer:
            nxt: List[Tuple[int, bytearray]] = []
            for off, data in pieces:
                end = off + len(data)
                if d.end <= off or d.offset >= end:
                    nxt.append((off, data))
                    continue
                if d.offset > off:
                    nxt.append((off, data[: d.offset - off]))
                if d.end < end:
                    nxt.append((d.end, data[d.end - off:]))
            pieces = nxt
        out.extend(_Extent(off, data) for off, data in pieces if data)
    return out


class _PageCache:
    """Per-agent block cache with lease-gated consistency (bounded LRU).

    Blocks are fixed-size (the tail block may be short) and keyed by
    ``((host_id, file_id), block_index)``.  A file's blocks are served or
    filled only while the agent holds that file's read lease; the
    revocation generation (bumped by every REVOKE_LEASE callback) makes
    fills atomic against a revoke crossing the wire: a READ response whose
    pre-RPC generation snapshot no longer matches is discarded, so a
    response that raced a revoke can never be cached — the same discipline
    the namespace cache applies to LOOKUP_DIR vs INVALIDATE (§3.4), moved
    to the data plane.  All state lives under one leaf lock and no method
    blocks on I/O, so callback handlers call in freely."""

    def __init__(self, block_size: int, budget: int) -> None:
        self.block_size = max(1, block_size)
        self.budget = max(0, budget)
        self._lock = threading.Lock()
        # (key, block_index) -> block bytes, LRU order (oldest first)
        self._blocks: "OrderedDict[Tuple[Tuple[int, int], int], bytes]" = \
            OrderedDict()
        self._by_ino: Dict[Tuple[int, int], set] = {}
        self._sizes: Dict[Tuple[int, int], int] = {}  # known object sizes
        self._gen: Dict[Tuple[int, int], int] = {}    # revocation generations
        self._leased: set = set()                     # keys with a live lease
        # (server incarnation, server wseq) the cached state corresponds
        # to.  serve() distrusts blocks from another incarnation (a restart
        # wiped the server's lease table, so no revoke would ever come),
        # and fill/patch discard responses older than the stamp — two acks
        # processed out of order can never regress the cache.
        self._stamp: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # key -> monotonic deadline after which the grant is dead (absent:
        # untimed lease).  The deadline is computed from a t0 stamped by
        # the CLIENT before the granting RPC left, while the server stamps
        # its copy when it processes the grant — so this clock always runs
        # ahead and the client stops serving strictly before the server
        # considers the lease expired and mutates without a callback.
        self._expiry: Dict[Tuple[int, int], float] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.revocations = 0
        self.lease_expiries = 0  # grants dropped at TTL, not by revoke

    def gen(self, key: Tuple[int, int]) -> int:
        with self._lock:
            return self._gen.get(key, 0)

    def known_size(self, key: Tuple[int, int]) -> Optional[int]:
        """Lease-validated object size, or None.  Counter-neutral on
        purpose: the readahead detector polls this and must not skew the
        hit/miss accounting the benchmarks assert on (expired grants are
        likewise only *observed* here; serve() does the actual drop)."""
        with self._lock:
            if key not in self._leased:
                return None
            exp = self._expiry.get(key)
            if exp is not None and time.monotonic() >= exp:
                return None
            return self._sizes.get(key)

    def revoke(self, key: Tuple[int, int]) -> None:
        """Server recalled the lease: bump the generation (kills in-flight
        fills), drop the grant and every cached block."""
        with self._lock:
            self._gen[key] = self._gen.get(key, 0) + 1
            self._leased.discard(key)
            self._expiry.pop(key, None)
            self._drop_locked(key)
            self.revocations += 1

    def drop(self, key: Tuple[int, int]) -> None:
        """Locally invalidate one file's blocks (own truncate or a failed
        flush).  The lease itself stays valid: the next read refills
        under it."""
        with self._lock:
            self._drop_locked(key)

    def forget(self, key: Tuple[int, int]) -> None:
        """Full cleanup for a file that no longer exists (we unlinked it):
        blocks, size, lease grant and stamp all go.  The revocation
        generation stays — it is the monotonic guard an in-flight fill is
        checked against, and its entry is a single int."""
        with self._lock:
            self._drop_locked(key)
            self._leased.discard(key)
            self._expiry.pop(key, None)
            self._stamp.pop(key, None)

    def _drop_locked(self, key: Tuple[int, int]) -> None:
        self._sizes.pop(key, None)
        for b in self._by_ino.pop(key, ()):
            blk = self._blocks.pop((key, b), None)
            if blk is not None:
                self._bytes -= len(blk)

    def serve(self, key: Tuple[int, int], offset: int, length: int,
              ver: int) -> Optional[Tuple[bytes, int]]:
        """Assemble ``[offset, offset+length)`` clipped to EOF from cached
        blocks.  Returns ``(data, object_size)``, or None on any miss — no
        live lease, an EXPIRED lease (past its TTL the server is free to
        mutate without calling us back, so the grant and its blocks are
        silently dropped and the next read re-validates over RPC), unknown
        size, a block not (fully) resident, or state stamped by another
        server incarnation than `ver` (the restarted server forgot our
        lease, so nothing would ever revoke us: distrust everything and
        refetch)."""
        bs = self.block_size
        with self._lock:
            st = self._stamp.get(key)
            if st is not None and st[0] != ver:
                self._drop_locked(key)
                self._leased.discard(key)
                self._expiry.pop(key, None)
                self._stamp.pop(key, None)
                self.misses += 1
                return None
            exp = self._expiry.get(key)
            if (exp is not None and key in self._leased
                    and time.monotonic() >= exp):
                self._leased.discard(key)
                self._expiry.pop(key, None)
                self._drop_locked(key)
                self.lease_expiries += 1
                self.misses += 1
                return None
            size = self._sizes.get(key) if key in self._leased else None
            if size is None:
                self.misses += 1
                return None
            end = min(offset + length, size)
            if end <= offset:
                self.hits += 1
                return b"", size
            first = offset // bs
            parts: List[bytes] = []
            for b in range(first, (end - 1) // bs + 1):
                blk = self._blocks.get((key, b))
                if blk is None or len(blk) < min(bs, size - b * bs):
                    self.misses += 1
                    return None
                parts.append(blk)
                self._blocks.move_to_end((key, b))
            self.hits += 1
            data = b"".join(parts)[offset - first * bs : end - first * bs]
            return data, size

    def fill(self, key: Tuple[int, int], gen: int, offset: int, data: bytes,
             size: int, ver: int, wseq: int,
             expires: Optional[float] = None) -> None:
        """Install a READ response, re-validating the lease generation
        snapshotted before the RPC was issued.  `ver` is the server
        incarnation the RPC was validated against, `wseq` the per-file
        mutation sequence the response carries: a response older than what
        the cache already holds (our own later write/truncate acked first)
        is discarded rather than allowed to regress the cache.  `expires`
        is the grant's TTL deadline (monotonic clock, computed from the
        pre-RPC t0) — two grants racing keep the later deadline, and None
        (a server that advertises no TTL) makes the lease untimed."""
        bs = self.block_size
        with self._lock:
            if self._gen.get(key, 0) != gen:
                return  # a revoke crossed this response on the wire
            st = self._stamp.get(key)
            if st is not None and st[0] == ver and st[1] > wseq:
                return  # stale response: the cache has newer acked state
            if st is not None and st[0] != ver:
                self._drop_locked(key)  # old-incarnation leftovers
            self._stamp[key] = (ver, wseq if st is None or st[0] != ver
                                else max(st[1], wseq))
            if expires is None:
                self._expiry.pop(key, None)
            else:
                cur = self._expiry.get(key)
                self._expiry[key] = (expires if cur is None
                                     else max(cur, expires))
            self._leased.add(key)
            self._sizes[key] = size
            end = offset + len(data)
            b = -(-offset // bs)  # first block starting inside the span
            while b * bs < end:
                bstart = b * bs
                blk = data[bstart - offset : bstart - offset + bs]
                # only fully-defined blocks are cacheable: a whole block,
                # or a tail that runs to EOF
                if blk and (len(blk) == bs or bstart + len(blk) >= size):
                    self._insert(key, b, blk)
                b += 1
            self._evict()

    def patch(self, key: Tuple[int, int], gen: int,
              extents: List[Tuple[int, bytes]],
              new_size: Optional[int], ver: int, wseq: int) -> None:
        """Overlay locally-written bytes onto existing cached state after
        the server acked them (sync write / completed flush).  Never
        creates state from nothing: with no cached size there is no
        lease-validated context to patch into, and the generation check
        discards a patch that lost a race with another writer's revoke.
        The (ver, wseq) stamp orders same-client patches: when two of our
        own writes are acked out of order, the older one is discarded
        instead of overwriting the newer (the server serialized them under
        the file lock; wseq is that serialization made visible)."""
        bs = self.block_size
        with self._lock:
            if self._gen.get(key, 0) != gen or key not in self._leased:
                return
            st = self._stamp.get(key)
            if st is None or st[0] != ver or st[1] > wseq:
                return
            self._stamp[key] = (ver, max(st[1], wseq))
            size = self._sizes.get(key)
            if size is None:
                return
            if new_size is not None and new_size > size:
                size = new_size
                self._sizes[key] = size
            for eoff, edata in extents:
                eend = eoff + len(edata)
                if eend <= eoff:
                    continue
                for b in range(eoff // bs, (eend - 1) // bs + 1):
                    bstart = b * bs
                    lo, hi = max(eoff, bstart), min(eend, bstart + bs)
                    cur = self._blocks.get((key, b))
                    if cur is None:
                        if lo == bstart and (hi - bstart == bs or hi >= size):
                            # the write alone fully defines this block
                            self._insert(key, b, edata[lo - eoff : hi - eoff])
                        continue
                    nb = bytearray(cur)
                    if len(nb) < hi - bstart:
                        # file grew within this block: the gap is
                        # zero-filled, exactly as the server materializes it
                        nb.extend(bytes(hi - bstart - len(nb)))
                    nb[lo - bstart : hi - bstart] = edata[lo - eoff : hi - eoff]
                    self._insert(key, b, bytes(nb))
            self._evict()

    def note_mutation(self, key: Tuple[int, int], ver: int, wseq: int) -> None:
        """Advance the stamp for a mutation we performed whose effect we do
        NOT patch in (a truncate: we drop the blocks instead).  Without
        this, a READ response already in flight when the truncate was
        acked would carry an equal-or-older wseq and re-install the
        pre-truncate bytes."""
        with self._lock:
            st = self._stamp.get(key)
            if st is None or st[0] != ver or st[1] < wseq:
                self._stamp[key] = (ver, wseq)

    def _insert(self, key: Tuple[int, int], b: int, blk: bytes) -> None:
        old = self._blocks.pop((key, b), None)
        if old is not None:
            self._bytes -= len(old)
        self._blocks[(key, b)] = bytes(blk)
        self._by_ino.setdefault(key, set()).add(b)
        self._bytes += len(blk)

    def _evict(self) -> None:
        while self._bytes > self.budget and self._blocks:
            (key, b), blk = self._blocks.popitem(last=False)
            self._bytes -= len(blk)
            s = self._by_ino.get(key)
            if s is not None:
                s.discard(b)
                if not s:
                    del self._by_ino[key]
            self.evictions += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "revocations": self.revocations,
                    "lease_expiries": self.lease_expiries,
                    "cached_bytes": self._bytes,
                    "cached_blocks": len(self._blocks),
                    "leased_files": len(self._leased)}


class _FlushJob:
    """One handle's unit of work in a write-behind flush cycle."""

    __slots__ = ("fh", "extents", "trunc", "io_h", "nbytes", "error",
                 "first_sub_failed", "gen", "ver", "new_size", "wseq",
                 "epoch")

    def __init__(self, fh: "FileHandle", extents: List[_Extent], trunc: bool,
                 io_h: Dict, gen: int = 0, ver: int = 0) -> None:
        self.fh = fh
        self.extents = extents
        self.trunc = trunc
        self.io_h = io_h
        self.nbytes = sum(len(e.data) for e in extents)
        self.error: Optional[FSError] = None
        self.first_sub_failed = False  # the sub carrying trunc/open record
        self.gen = gen                 # cache generation at snapshot time
        self.ver = ver                 # server incarnation at snapshot time
        self.new_size: Optional[int] = None  # max size acked by the server
        self.wseq = 0                  # max mutation seq acked by the server
        self.epoch = 0                 # chunk epoch the scatter ran under

    @property
    def trunc_only(self) -> bool:
        return self.trunc and not self.extents


@dataclass(eq=False)  # identity semantics: handles live in flush-queue sets
class FileHandle:
    fd: int
    ino: int
    flags: int
    path: str
    offset: int = 0
    incomplete_open: bool = True   # deferred open step-2 not yet done
    pending_trunc: bool = False
    layout: Optional[Dict] = None  # stripe layout from the dentry (or None)
    # sequential-read detector state (readahead): the offset the next read
    # must start at to count as sequential, and the high-water mark up to
    # which readahead has already been scheduled for this handle
    ra_next: int = -1
    ra_sched: int = 0
    # --- write-behind state (all guarded by the agent's _wb_cond) ---
    dirty: List[_Extent] = field(default_factory=list)
    wb_inflight: bool = False      # a flusher is carrying this handle's data
    wb_closing: bool = False       # closed with unflushed state: flush, then CLOSE
    wb_error: Optional[FSError] = None  # latched flush error (CannyFS-style)
    # retryable-latch refinement: a flush that died on a TRANSIENT errno
    # (host unreachable — plausibly mid-failover, awaiting promotion) keeps
    # its bytes in wb_stalled and marks the latch retryable; the next sync
    # point (write/fsync/close) clears the latch and restages the bytes for
    # another flush, which lands once _rpc_recover's config redirect does.
    # A non-transient failure latches permanent and re-raises as before.
    wb_retryable: bool = False
    wb_stalled: List[_Extent] = field(default_factory=list)


class BAgent:
    """The per-client BuffetFS agent."""

    def __init__(self, cluster: BuffetCluster, *, cred: Credentials = Credentials(),
                 pid: int = 1, client_id: Optional[str] = None,
                 hedge_delay_s: Optional[float] = None,
                 write_behind: bool = False,
                 dirty_budget: int = DEFAULT_DIRTY_BUDGET,
                 read_cache: bool = False,
                 cache_block: int = DEFAULT_CACHE_BLOCK,
                 cache_budget: int = DEFAULT_CACHE_BUDGET,
                 readahead: bool = False,
                 readahead_window: int = DEFAULT_READAHEAD_WINDOW) -> None:
        self.cluster = cluster
        self.transport: Transport = cluster.transport
        self.config: ClusterConfig = cluster.config
        self.cred = cred
        self.pid = pid
        self.client_id = client_id or f"bagent-{next(_agent_counter)}"
        self.cb_addr = f"cb:{self.client_id}"
        self.stats = RpcStats()
        self.hedge_delay_s = hedge_delay_s

        self.root = TreeNode("", cluster.root_ino,
                             PermRecord(0o040755, 0, 0), parent=None)
        self._tree_lock = threading.RLock()
        # per-directory invalidation generation, bumped by every INVALIDATE
        # callback (even for dirs not yet in the tree).  Fetch paths
        # snapshot it before the RPC and refuse to mark a directory valid
        # if its generation moved while the response was in flight —
        # otherwise a pre-mutation snapshot crossing an INVALIDATE on the
        # wire would be cached as valid-but-stale forever.
        self._inval_gen: Dict[Tuple[int, int], int] = {}
        # (host_id, file_id) -> TreeNode index so an INVALIDATE callback is
        # O(1) instead of a full-tree scan (the server blocks on our ack,
        # so callback latency is mutation latency).  Stale entries for
        # dropped nodes are harmless: invalidating a detached node is a
        # no-op for the live tree.
        self._node_index: Dict[Tuple[int, int], TreeNode] = {
            _ino_key(self.root.ino): self.root}
        self._fd_lock = threading.Lock()
        self._fds: Dict[int, FileHandle] = {}
        self._next_fd = 3

        # async close worker (paper: close() returns immediately, RPC async)
        self._close_q: "queue.Queue[Optional[Message]]" = queue.Queue()
        self._closer = threading.Thread(target=self._close_worker, daemon=True)
        self._closer.start()

        # write-behind pipeline state.  _wb_cond guards every field below
        # plus the per-handle dirty/wb_* fields; flusher threads (one per
        # host, lazily started) wait on it and every state transition
        # notifies it (backpressure waiters, drains, fsync barriers).
        self.write_behind = write_behind
        self.dirty_budget = dirty_budget
        self._wb_cond = threading.Condition()
        self._wb_dirty_bytes = 0
        self._wb_inflight = 0                       # handles being flushed
        self._wb_pending: Dict[int, Dict[int, FileHandle]] = {}  # host->fd->fh
        self._wb_by_ino: Dict[Tuple[int, int], set] = {}  # unflushed handles
        # jobs snapshotted out of fh.dirty but not yet acked: their extents
        # must keep shadowing cached clean blocks until the flush lands
        self._wb_inflight_jobs: Dict[Tuple[int, int], List[_FlushJob]] = {}
        self._wb_flushers: Dict[int, threading.Thread] = {}
        self._wb_stop = False
        # asynchronous failures nobody could be told about synchronously:
        # failed async CLOSE RPCs + flush errors on already-closed handles.
        # drain() returns it so benchmarks/tests can assert clean shutdown.
        self.async_errors = 0

        # per-file chunk epochs learned from striped responses (READ/
        # commit/TRUNCATE headers and EPOCHSTALE refusals).  A scatter is
        # stamped with the epoch known here; a stale guess never corrupts
        # anything — the stripe hosts refuse it or the commit dies
        # EPOCHSTALE — it only costs one retry at the epoch the refusal
        # hands back.  Monotonic per key (epochs never move backwards).
        self._epoch_lock = threading.Lock()
        self._epochs: Dict[Tuple[int, int], int] = {}
        self.epoch_retries = 0  # scatter/commit rounds re-run EPOCHSTALE

        # home-host failover recovery (§3.2 out-of-band config push):
        # connection-refused/timeout RPCs retry with capped exponential
        # backoff, re-reading the cluster config every attempt so the
        # moment an admin promote() re-points this host id at its standby
        # the retry lands on the new authority instead of raising
        self.failover_retry_max = 8
        self.failover_backoff_s = 0.02
        self.failover_backoff_cap_s = 0.25
        self.failover_retries = 0    # backoff retries issued
        self.failover_redirects = 0  # retries that switched address

        # replicated-chunk read health (r>1 layouts only): spans whose
        # CHUNK_READ was duplicated to the next replica by the hedge
        # timer, spans the hedge answered first, and error-driven
        # replica-failover waves (a dead primary bridged transparently)
        self.hedged_reads = 0
        self.hedge_wins = 0
        self.read_failovers = 0

        # client-cached cluster group-membership table (uid -> extra gids),
        # fetched lazily from the authority host the first time an ACL "g"
        # entry needs a membership the local cred cannot answer, then served
        # RPC-free until invalidated.  `_groups_gen` is its invalidation
        # generation (same pre-RPC snapshot discipline as _inval_gen);
        # `_groups_gver` the latest table version seen in any response.
        self._groups_table: Optional[Dict[int, List[int]]] = None
        self._groups_gen = 0
        self._groups_gver = 0
        # critical RPCs issued FROM permission evaluation (group-table
        # fetches): warm permission checks must keep this flat — the
        # fig12 "serve yourself" gate
        self.perm_check_rpcs = 0

        # lease-consistent page cache (None => every read RPCs as before)
        self._cache: Optional[_PageCache] = (
            _PageCache(cache_block, cache_budget) if read_cache else None)

        # asynchronous readahead (requires the page cache: the prefetched
        # blocks land there under the same lease/generation discipline as
        # any demand fill, so coherence is untouched).  A single daemon
        # worker keeps readahead RPCs strictly off the critical path.
        self.readahead_window = readahead_window
        self._ra_q: Optional["queue.Queue"] = (
            queue.Queue() if (readahead and read_cache) else None)
        # in-flight prefetch windows: (key, lo, hi) -> completion event, so
        # a demand read that lands inside one WAITS for the fill instead of
        # duplicating the RPCs it is about to satisfy
        self._ra_inflight: Dict[Tuple, threading.Event] = {}
        self._ra_lock = threading.Lock()
        self.readaheads = 0  # windows issued (monotonic, informational)
        if self._ra_q is not None:
            threading.Thread(target=self._ra_worker, daemon=True).start()

        # invalidation callback endpoint (server -> client RPCs, §3.4)
        from .transport import TCPTransport
        if isinstance(self.transport, TCPTransport):
            self.cb_addr = "127.0.0.1:0"  # real listener, ephemeral port
        real = self.transport.serve(self.cb_addr, self._handle_callback)
        if real:
            self.cb_addr = real

    # ------------------------------------------------------------------
    # RPC plumbing with ESTALE/version + failover recovery
    # ------------------------------------------------------------------
    def _rpc(self, host_id: int, msg: Message, *, critical: bool = True) -> Message:
        addr = self.config.addr(host_id)
        msg.header["ver"] = self.config.version(host_id)
        resp = self.transport.request(addr, msg,
                                      critical=critical, stats=self.stats)
        if resp.type is MsgType.ERROR:
            resp = self._rpc_recover(host_id, msg, resp, addr, critical)
        if resp.type is MsgType.ERROR:
            raise self._wire_err(resp)
        return resp

    def _rpc_recover(self, host_id: int, msg: Message, resp: Message,
                     addr: str, critical: bool) -> Message:
        """Recovery tail of `_rpc`, entered only on an ERROR frame.

        Two recoverable failure classes, both rooted in §3.2's "the
        configuration file is pushed out-of-band" model:

        * **ESTALE** — the server's incarnation moved (restart or standby
          promotion).  Re-learn the version: if the cluster config already
          names a new address/version (an admin promote() updated the
          shared config) just re-stamp; otherwise PING the server for its
          current incarnation, exactly the old one-shot recovery.

        * **connection failures** (refused / not-connected / timeout /
          unreachable) — the home may be crashed and mid-failover.  Retry
          with capped exponential backoff, re-reading the config each
          attempt: the moment promote() re-points the host id at the
          promoted standby, the next attempt lands there.  A genuinely
          dead, never-promoted host still fails after the retry budget —
          the caller sees the original errno.

        Every attempt that switched addresses counts as a redirect
        (``failover_redirects``); every backoff retry counts in
        ``failover_retries``."""
        stale_left = 2
        attempts_left = self.failover_retry_max
        delay = self.failover_backoff_s
        while resp.type is MsgType.ERROR:
            eno = resp.header.get("errno")
            if eno == errno.ESTALE and stale_left > 0:
                stale_left -= 1
                if self.config.addr(host_id) == addr:
                    try:
                        self.cluster.refresh_host(host_id)
                    except (ConnectionError, OSError):
                        return resp  # can't even PING: surface the ESTALE
            elif eno in _TRANSIENT_ERRNOS and attempts_left > 0:
                attempts_left -= 1
                self.failover_retries += 1
                if self.config.addr(host_id) == addr:
                    # no new authority yet: wait for one
                    time.sleep(delay)
                    delay = min(delay * 2, self.failover_backoff_cap_s)
            else:
                return resp
            cur = self.config.addr(host_id)
            if cur != addr:
                self.failover_redirects += 1
                addr = cur
            msg.header["ver"] = self.config.version(host_id)
            resp = self.transport.request(addr, msg,
                                          critical=critical, stats=self.stats)
        return resp

    @staticmethod
    def _wire_err(resp: Message) -> FSError:
        """ERROR frame -> FSError; an EPOCHSTALE refusal carries the
        current chunk epoch in its header, preserved on the exception so
        the retry can re-scatter at the right epoch without another RPC."""
        e = err(resp.header.get("errno", errno.EIO),
                resp.header.get("msg", ""))
        if "epoch" in resp.header:
            e.epoch = resp.header["epoch"]
        return e

    def _epoch_of(self, key: Tuple[int, int]) -> int:
        with self._epoch_lock:
            return self._epochs.get(key, 0)

    def _note_epoch(self, key: Tuple[int, int], epoch: Optional[int]) -> None:
        if epoch is None:
            return
        with self._epoch_lock:
            if epoch > self._epochs.get(key, 0):
                self._epochs[key] = epoch

    def _rpc_batch(self, host_id: int, msgs: List[Message], *,
                   critical: bool = True) -> List[Message]:
        """Send N sub-messages to one host in a single BATCH frame (one
        round trip).  Returns the N sub-responses; per-sub errors are left
        to the caller, envelope-level errors raise (with the same one-shot
        ESTALE/version recovery as `_rpc`)."""
        if not msgs:
            return []
        if len(msgs) == 1:
            # same ESTALE/version recovery as any other RPC.  Server-level
            # per-op failures surface as a per-sub ERROR (this method's
            # contract); transport-level failures raise, exactly as the
            # multi-message envelope path does — a caller must not get
            # "silently skipped" vs "raised" depending on chunk size.
            try:
                return [self._rpc(host_id, msgs[0], critical=critical)]
            except FSError as e:
                if e.errno in (errno.ENOTCONN, errno.ETIMEDOUT,
                               errno.ECONNREFUSED, errno.ESTALE):
                    raise
                we = wire_error(e.errno or errno.EIO, str(e))
                if hasattr(e, "epoch"):  # EPOCHSTALE keeps its epoch hint
                    we.header["epoch"] = e.epoch
                return [we]
        # the envelope rides the ordinary RPC path: _rpc stamps the server
        # incarnation, retries once on ESTALE, and raises on envelope-level
        # errors — one copy of the recovery protocol, not two
        return unpack_batch(self._rpc(host_id, pack_batch(msgs),
                                      critical=critical))

    def _rpc_many(self, host_id: int, msgs: List[Message], *,
                  critical: bool = True) -> List[Message]:
        """Pipeline N independent frames to one host via the transport's
        request_many (all outstanding at once, ~1 RTT + N service times),
        with the usual ESTALE/version and failover recovery applied per
        frame.  Responses are returned as-is — ERROR frames included —
        because the write-behind flusher must map failures back to
        individual handles rather than abort the whole flush cycle;
        recoverable frames (stale incarnation, connection failure) are
        re-driven one by one through `_rpc`'s full retry machinery, and a
        frame that stays dead after the retry budget comes back as the
        ERROR frame this contract promises, never a raise."""
        addr = self.config.addr(host_id)
        for m in msgs:
            m.header["ver"] = self.config.version(host_id)
        resps = self.transport.request_many(addr, msgs, critical=critical,
                                            stats=self.stats)
        redo = [i for i, r in enumerate(resps)
                if r.type is MsgType.ERROR
                and (r.header.get("errno") == errno.ESTALE
                     or r.header.get("errno") in _TRANSIENT_ERRNOS)]
        for i in redo:
            try:
                resps[i] = self._rpc(host_id, msgs[i], critical=critical)
            except FSError as e:
                we = wire_error(e.errno or errno.EIO, str(e))
                if hasattr(e, "epoch"):
                    we.header["epoch"] = e.epoch
                resps[i] = we
                if (e.errno in _TRANSIENT_ERRNOS
                        and self.config.addr(host_id) == addr):
                    # the full retry budget found nobody home and no new
                    # authority was pushed: the remaining frames would burn
                    # the same budget to hear the same thing — leave their
                    # original ERROR frames standing
                    break
        return resps

    # ------------------------------------------------------------------
    # invalidation callback (§3.4): mark-before-ack => strong consistency
    # ------------------------------------------------------------------
    def _handle_callback(self, msg: Message) -> Message:
        if msg.type is MsgType.INVALIDATE:
            if msg.header.get("groups"):
                # group-table invalidation (blocking SETGROUPS fan-out):
                # drop the table and bump its generation BEFORE acking, so
                # once the server applies the change no check here can
                # evaluate against the withdrawn membership
                with self._tree_lock:
                    self._groups_gen += 1
                    self._groups_table = None
                return ok()
            dir_ino = msg.header["dir_ino"]
            with self._tree_lock:
                key = _ino_key(dir_ino)
                self._inval_gen[key] = self._inval_gen.get(key, 0) + 1
                node = self._node_index.get(key)
                if node is not None:
                    node.valid = False
            return ok()
        if msg.type is MsgType.REVOKE_LEASE:
            # the server blocks the mutating writer on this ack: once we
            # return, no cached block for the file exists anywhere in this
            # agent, so the write can be applied/acked without any client
            # being able to serve the pre-mutation data
            if self._cache is not None:
                self._cache.revoke(_ino_key(msg.header["ino"]))
            return ok()
        return ok()

    def _gen_snapshot(self) -> Dict[Tuple[int, int], int]:
        with self._tree_lock:
            return dict(self._inval_gen)

    def _forget_node(self, node: TreeNode) -> None:
        """Drop a detached node (and its subtree) from the lookup index and
        the generation map so long-lived agents on churny namespaces don't
        retain every TreeNode ever seen.  Caller holds _tree_lock."""
        key = _ino_key(node.ino)
        if self._node_index.get(key) is node:
            del self._node_index[key]
            self._inval_gen.pop(key, None)
        for c in (node.children or {}).values():
            self._forget_node(c)

    # ------------------------------------------------------------------
    # directory-tree management
    # ------------------------------------------------------------------
    def _fetch_dir(self, node: TreeNode) -> None:
        """LOOKUP_DIR: pull a directory's dentries + child perms, register as
        watcher.  This is the only metadata RPC BuffetFS ever needs."""
        ino = Inode.unpack(node.ino)
        # only this dir's generation matters here; the full-map snapshot is
        # reserved for the bulk paths, whose response dir set is unknown
        key = _ino_key(node.ino)
        with self._tree_lock:
            gens = {key: self._inval_gen.get(key, 0)}
        resp = self._rpc(ino.host_id, Message(MsgType.LOOKUP_DIR, {
            "file_id": ino.file_id, "client_id": self.client_id,
            "cb_addr": self.cb_addr}))
        self._merge_dir(node, resp.header, gens=gens)

    def _merge_dir(self, node: TreeNode, record: Dict,
                   gens: Optional[Dict[Tuple[int, int], int]] = None) -> None:
        """Install a directory's fetched dentries + perms into the cached
        tree (shared by LOOKUP_DIR responses and LOOKUP_TREE dir records).

        `gens` is the invalidation-generation snapshot taken before the
        fetch RPC was issued: if this directory was invalidated while the
        response was in flight, the data is merged (still useful) but the
        node stays invalid so the next access revalidates."""
        with self._tree_lock:
            self._note_gver(record.get("gver"))
            node.perm = PermRecord.unpack(bytes.fromhex(record["perm"]))
            old = node.children or {}
            fresh: Dict[str, TreeNode] = {}
            for e in record["entries"]:
                perm = PermRecord.unpack(bytes.fromhex(e["perm"]))
                child = old.get(e["name"])
                if child is None or _ino_key(child.ino) != _ino_key(e["ino"]):
                    # unseen name, or the name now points at a different
                    # object: start a fresh node
                    child = TreeNode(e["name"], e["ino"], perm, parent=node,
                                     layout=e.get("layout"),
                                     acl=e.get("acl"))
                    self._node_index[_ino_key(child.ino)] = child
                else:
                    # refresh what the parent's entries carry (ino version,
                    # perm, layout, acl) but do NOT touch child.valid: that
                    # flag covers the child's OWN listing, whose
                    # invalidations arrive separately — re-marking it valid
                    # here would resurrect a stale child dentry cache (§3.4
                    # violation)
                    child.ino, child.perm = e["ino"], perm
                    child.layout = e.get("layout")
                    child.acl = e.get("acl")
                fresh[e["name"]] = child
            for name, old_child in old.items():
                if fresh.get(name) is not old_child:
                    self._forget_node(old_child)  # dentry gone or replaced
            node.children = fresh
            if gens is None:
                node.valid = True
            else:
                key = _ino_key(node.ino)
                node.valid = (self._inval_gen.get(key, 0) == gens.get(key, 0))

    def _ensure_children(self, node: TreeNode) -> Dict[str, "TreeNode"]:
        if not node.perm.is_dir:
            raise err(errno.ENOTDIR, node.path())
        if node.children is None or not node.valid:
            self._fetch_dir(node)
        assert node.children is not None
        return node.children

    # ------------------------------------------------------------------
    # rich permission evaluation (ACL + group grants, still client-side)
    # ------------------------------------------------------------------
    def _note_gver(self, gver: Optional[int]) -> None:
        """Track the newest group-table version seen in any response
        (caller holds _tree_lock).  A newer version than the cached table
        drops it — the lazy-refetch safety net for revocations whose
        blocking callback could not reach us (e.g. the table authority
        failed over and the promoted standby never knew this watcher)."""
        if gver and gver > self._groups_gver:
            self._groups_gver = gver
            if self._groups_table is not None:
                self._groups_table = None
                self._groups_gen += 1

    def _group_table(self) -> Dict[int, List[int]]:
        """The cluster group table, cached under the invalidation-generation
        discipline: snapshot the generation before the RPC and refuse to
        cache (retrying instead) if an invalidation crossed the fetch —
        otherwise a pre-SETGROUPS snapshot could authorize a withdrawn
        membership after the mutation acked."""
        authority = Inode.unpack(self.root.ino).host_id
        while True:
            with self._tree_lock:
                if self._groups_table is not None:
                    return self._groups_table
                gen = self._groups_gen
            resp = self._rpc(authority, Message(MsgType.LOOKUP_GROUPS, {
                "client_id": self.client_id, "cb_addr": self.cb_addr}))
            self.perm_check_rpcs += 1
            table = normalize_groups(resp.header.get("groups"))
            gver = resp.header.get("gver", 0)
            with self._tree_lock:
                if self._groups_gen == gen and gver >= self._groups_gver:
                    self._groups_table = table
                    self._groups_gver = max(self._groups_gver, gver)
                    return table

    def _extra_groups(self, acl: List) -> Tuple[int, ...]:
        """Extra group memberships relevant to evaluating `acl` for this
        credential.  RPC-free unless the ACL carries a "g" entry the local
        cred cannot answer AND the table is not cached yet — after that
        one cold fetch, every check is served from the cached table."""
        if not any(kind == "g" and not self.cred.in_group(ident)
                   for kind, ident, _a, _d in acl):
            return ()
        return tuple(self._group_table().get(self.cred.uid, ()))

    def _access(self, node: TreeNode, want: int) -> bool:
        """The paper's client-side check, grown rich: mode bits from the
        10-byte record plus the dentry's ACL entries plus group-table
        memberships — all evaluated locally."""
        acl = node.acl
        if not acl:
            return access_ok(node.perm, self.cred, want)
        return access_ok(node.perm, self.cred, want, acl=acl,
                         groups=self._extra_groups(acl))

    def _walk(self, path: str, *, want_parent: bool = False
              ) -> Tuple[TreeNode, Optional[str]]:
        """Traverse the cached tree, checking X permission on every directory
        component CLIENT-SIDE (the paper's core mechanism).  Returns the node
        (or its parent + final name if `want_parent`)."""
        if not path.startswith("/"):
            raise err(errno.EINVAL, f"path must be absolute: {path}")
        parts = [p for p in path.split("/") if p]
        node = self.root
        # root perm comes with the first LOOKUP_DIR; check X on each dir
        stop = len(parts) - 1 if want_parent else len(parts)
        for i in range(stop):
            if not self._access(node, X_OK):
                raise err(errno.EACCES, f"search permission denied: {node.path()}")
            children = self._ensure_children(node)
            child = children.get(parts[i])
            if child is None:
                raise err(errno.ENOENT, "/" + "/".join(parts[: i + 1]))
            node = child
        if want_parent:
            if not self._access(node, X_OK):
                raise err(errno.EACCES, f"search permission denied: {node.path()}")
            self._ensure_children(node)
            return node, (parts[-1] if parts else None)
        return node, None

    # ------------------------------------------------------------------
    # POSIX-ish operations
    # ------------------------------------------------------------------
    def open(self, path: str, flags: int = 0, mode: int = 0o644) -> int:
        """open() with ZERO server RPCs when the parent chain is cached.

        Step 1 (permission check) happens here, locally, against the cached
        10-byte records.  Step 2 (open-state recording) is deferred to the
        first READ/WRITE (`incomplete_open`).
        """
        parent, name = self._walk(path, want_parent=True)
        if name is None:
            raise err(errno.EISDIR, path)
        children = parent.children or {}
        node = children.get(name)
        if node is None:
            if not (flags & O_CREAT):
                raise err(errno.ENOENT, path)
            if not self._access(parent, W_OK):
                raise err(errno.EACCES, f"cannot create in {parent.path()}")
            node = self._create(parent, name, mode)
        else:
            want = flags_to_access(flags)
            if not self._access(node, want):
                raise err(errno.EACCES, path)
            if node.perm.is_dir and (want & W_OK):
                raise err(errno.EISDIR, path)
        with self._fd_lock:
            fd = self._next_fd
            self._next_fd += 1
            self._fds[fd] = FileHandle(fd=fd, ino=node.ino, flags=flags, path=path,
                                       pending_trunc=bool(flags & O_TRUNC),
                                       layout=node.layout)
        return fd

    def _create_msg(self, pino: Inode, name: str, mode: int,
                    path: str) -> Message:
        h = {"parent": pino.file_id, "name": name, "mode": mode,
             "uid": self.cred.uid, "gid": self.cred.gid,
             "client_id": self.client_id}
        # stripe layout is allocated CLIENT-side from the local cluster
        # config (rotating placement; the parent's host stays hosts[0], the
        # coherence home) and travels in the CREATE — the server stores it
        # in the dentry and FileMeta.  None while striping is disabled.
        layout = self.cluster.place_stripes(path, pino.host_id)
        if layout is not None:
            h["layout"] = layout
        return Message(MsgType.CREATE, h)

    def _install_child(self, parent: TreeNode, name: str, header: Dict
                       ) -> TreeNode:
        """Install a CREATE/MKNOD response's (ino, perm) into the tree."""
        perm = PermRecord.unpack(bytes.fromhex(header["perm"]))
        with self._tree_lock:
            node = TreeNode(name, header["ino"], perm, parent=parent,
                            layout=header.get("layout"),
                            acl=header.get("acl"))
            self._node_index[_ino_key(node.ino)] = node
            if parent.children is not None:
                parent.children[name] = node
        return node

    def _create(self, parent: TreeNode, name: str, mode: int) -> TreeNode:
        pino = Inode.unpack(parent.ino)
        path = parent.path().rstrip("/") + "/" + name
        resp = self._rpc(pino.host_id, self._create_msg(pino, name, mode,
                                                        path))
        return self._install_child(parent, name, resp.header)

    def _io_header(self, fh: FileHandle) -> Dict:
        h: Dict = {}
        if fh.incomplete_open:
            h["incomplete_open"] = {"client_id": self.client_id,
                                    "pid": self.pid, "fd": fh.fd,
                                    "flags": fh.flags}
            fh.incomplete_open = False
        return h

    def _flush_trunc(self, fh: FileHandle, *, ignore_enoent: bool = False
                     ) -> None:
        """The O_TRUNC from open() is deferred onto the first WRITE; any
        other operation that observes file contents (read, close) must
        flush it first or the caller sees pre-truncation data."""
        if not fh.pending_trunc:
            return
        ino = Inode.unpack(fh.ino)
        h = {"file_id": ino.file_id, "size": 0,
             "client_id": self.client_id, **self._io_header(fh)}
        ver = (self.config.version(ino.host_id)
               if self._cache is not None else 0)
        resp = None
        try:
            resp = self._rpc(ino.host_id, Message(MsgType.TRUNCATE, h))
        except FSError as e:
            if not (ignore_enoent and e.errno == errno.ENOENT):
                raise
        fh.pending_trunc = False
        if resp is not None:
            self._note_epoch(_ino_key(fh.ino), resp.header.get("epoch"))
        if self._cache is not None:  # pre-truncation blocks are dead
            key = _ino_key(fh.ino)
            self._cache.drop(key)
            if resp is not None:
                # stamp past the truncate so an in-flight pre-truncate READ
                # response cannot re-install the dropped bytes
                self._cache.note_mutation(key, ver,
                                          resp.header.get("wseq", 0))

    # ------------------------------------------------------------------
    # the read path: ONE code path for cached, write-behind-shadowed and
    # uncached reads
    # ------------------------------------------------------------------
    def read(self, fd: int, n: int = -1) -> bytes:
        fh = self._fh(fd)
        start = fh.offset
        data = self._read_span(fh, start, n)
        fh.offset += len(data)
        if self._ra_q is not None and data:
            self._maybe_readahead(fh, start)
        return data

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        return self._read_span(self._fh(fd), offset, n)

    def _read_span(self, fh: FileHandle, offset: int, n: int) -> bytes:
        """Serve ``[offset, offset+n)`` (n<0 => to EOF).  Warm path: the
        lease-gated page cache, with locally-buffered dirty extents
        shadowing the clean blocks — zero RPCs, no drain.  Cold path:
        drain the file's buffered writes (read-your-writes), flush any
        deferred O_TRUNC, then fetch — one READ RPC for an unstriped
        file; for a striped file the home host's READ supplies size/wseq/
        lease (plus whatever prefix lives in its own chunks) and the rest
        is gathered from the stripe hosts in parallel.  Either way the
        result refills the cache under the lease granted with it."""
        length = n if n >= 0 else (1 << 31)
        if self._cache is not None:
            data = self._cached_read(fh, offset, length)
            if data is not None:
                return data
            # a prefetch already racing toward this offset?  Wait for its
            # fill and retry the cache rather than duplicating its RPCs.
            ev = self._ra_covering(_ino_key(fh.ino), offset)
            if ev is not None and ev.wait(5.0):
                data = self._cached_read(fh, offset, length)
                if data is not None:
                    return data
        self._wb_drain_key(_ino_key(fh.ino))  # read-your-writes barrier
        self._flush_trunc(fh)
        return self._fetch_span(fh, offset, length)

    def _ra_covering(self, key: Tuple[int, int], offset: int
                     ) -> Optional[threading.Event]:
        if self._ra_q is None:
            return None
        with self._ra_lock:
            for (k, lo, hi), ev in self._ra_inflight.items():
                if k == key and lo <= offset < hi:
                    return ev
        return None

    def _fetch_span(self, fh: FileHandle, offset: int, length: int, *,
                    critical: bool = True, record_open: bool = True) -> bytes:
        """The RPC half of a read: home-host READ (lease grant + size +
        wseq + any local-chunk prefix), then — for striped files — a
        parallel CHUNK_READ scatter-gather across the stripe hosts
        (~1 RTT + max-per-host service instead of a serial sum).  Fills
        the page cache under the pre-RPC generation snapshot.  Readahead
        reuses this path with ``critical=False, record_open=False`` (a
        prefetch RPC must neither block accounting nor consume the
        deferred-open record)."""
        key = _ino_key(fh.ino)
        ino = Inode.unpack(fh.ino)
        h = {"file_id": ino.file_id, "offset": offset, "length": length}
        if record_open:
            h.update(self._io_header(fh))
        gen, ver, t0 = self._lease_request(key, ino.host_id, h)
        resp = self._rpc(ino.host_id, Message(MsgType.READ, h),
                         critical=critical)
        self._note_epoch(key, resp.header.get("epoch"))
        size = resp.header.get("size", offset + len(resp.payload))
        if fh.layout is None:
            data = resp.payload
        else:
            end = min(offset + length, size)
            if end <= offset:
                data = b""
            else:
                # the home host serves the span inline only when it covers
                # it entirely (all-home small files: zero extra copies);
                # otherwise the payload is empty (the server's
                # _read_local_span is all-or-nothing) and the whole span
                # is gathered from the stripe hosts
                if len(resp.payload) >= end - offset:
                    data = (resp.payload
                            if len(resp.payload) == end - offset
                            else resp.payload[: end - offset])
                else:
                    data = self._gather_chunks(ino, fh.layout, offset, end,
                                               critical=critical)
        if not isinstance(data, bytes):
            # materialization boundary: the transport hands payloads back as
            # memoryviews over the received frame; anything returned to the
            # caller (or retained in the page cache) must own its bytes
            data = bytes(data)
        if self._cache is not None and resp.header.get("lease"):
            ttl = resp.header.get("lease_ttl_ms")
            self._cache.fill(key, gen, offset, data, size, ver,
                             resp.header.get("wseq", 0),
                             expires=(t0 + ttl / 1000.0)
                             if ttl is not None else None)
        return data

    # ------------------------------------------------------------------
    # striped scatter-gather fan-out
    # ------------------------------------------------------------------
    def _fanout_hosts(self, per_host: Dict[int, List], fn) -> None:
        """Run ``fn(host, items)`` for every host concurrently (first host
        on the calling thread, the rest on short-lived threads — the
        per-host pipelining inside fn is where the real parallelism is).
        The first failure is re-raised on the caller."""
        items = list(per_host.items())
        if not items:
            return
        if len(items) == 1:
            fn(*items[0])
            return
        failures: List[BaseException] = []

        def runner(host: int, msgs) -> None:
            try:
                fn(host, msgs)
            except BaseException as e:
                failures.append(e)

        threads = [threading.Thread(target=runner, args=(h, it))
                   for h, it in items[1:]]
        for t in threads:
            t.start()
        runner(*items[0])
        for t in threads:
            t.join()
        if failures:
            raise failures[0]

    def _gather_chunks(self, ino: Inode, layout: Dict, start: int, end: int,
                       *, critical: bool) -> bytes:
        """Gather [start, end) of a striped file: split at stripe
        boundaries, group by stripe host, pipeline each host's
        CHUNK_READs and run the hosts concurrently.  Payloads land in
        their file-order slots (zero-padded to the span length — a short
        response is a hole) and ONE join produces the result: on a
        GIL-bound client, minimizing memcpy passes matters as much as
        overlapping the RPCs.  Replicated layouts (r>1) take the hedged/
        failover path instead."""
        if min(layout.get("r", 1), len(layout["hosts"])) > 1:
            return self._gather_replicated(ino, layout, start, end,
                                           critical=critical)
        n_spans = 0
        per_host: Dict[int, List[Tuple[int, Message]]] = {}
        for idx, host, coff, clen in stripe_spans(layout, start, end):
            per_host.setdefault(host, []).append(
                (n_spans, Message(MsgType.CHUNK_READ, {
                    "home": ino.host_id, "file_id": ino.file_id,
                    "index": idx, "offset": coff, "length": clen})))
            n_spans += 1
        parts: List[Optional[bytes]] = [None] * n_spans

        def fetch(host: int, items) -> None:
            resps = self._rpc_many(host, [m for _, m in items],
                                   critical=critical)
            for (slot, m), r in zip(items, resps):
                if r.type is MsgType.ERROR:
                    raise err(r.header.get("errno", errno.EIO),
                              r.header.get("msg", "chunk read failed"))
                clen = m.header["length"]
                p = r.payload  # may be a memoryview; the join below copies
                parts[slot] = p if len(p) == clen \
                    else bytes(p) + bytes(clen - len(p))

        self._fanout_hosts(per_host, fetch)
        if len(parts) == 1:
            # single-chunk span: possibly still a view; the caller
            # (_fetch_span) materializes at its return boundary
            return parts[0]
        return b"".join(parts)  # type: ignore[arg-type]

    def _gather_replicated(self, ino: Inode, layout: Dict, start: int,
                           end: int, *, critical: bool) -> bytes:
        """Gather from a replicated (r>1) layout: primary replicas first,
        a hedge timer (`hedge_delay_s`, default DEFAULT_HEDGE_DELAY_S)
        duplicating the still-outstanding spans to the next replica —
        first response wins, the loser's bytes are discarded — and
        error-driven failover to the next replica the moment a replica
        errors, so a dead stripe host is a latency blip, not an outage.

        Winner rule (stale-copy safety): an absent or short chunk reads
        as a truncated payload — a hole — but a hole is indistinguishable
        from an under-replicated copy on a host that rejoined before the
        scrubber repaired it (the primary included: a restart makes it no
        more authoritative than any replica).  So only a FULL-length
        response may win a span immediately; every short response is kept
        as a last-resort fallback, and only once ALL replicas have
        answered or failed does the longest fallback zero-pad the span —
        a genuinely sparse span costs a full fan-out, a stale short copy
        never shadows a complete one.  EIO only when ALL replicas of some
        span failed."""
        spans = list(stripe_spans(layout, start, end))
        n = len(spans)
        r = min(layout.get("r", 1), len(layout["hosts"]))
        cond = threading.Condition()
        results: List[Optional[bytes]] = [None] * n
        fallback: List[Optional[bytes]] = [None] * n
        filled = [False] * n
        state = {"remaining": n, "active": 0, "errors": 0, "failover": False}

        def attempt(rank: int) -> None:
            try:
                per_host: Dict[int, List[Tuple[int, Message]]] = {}
                with cond:
                    todo = [i for i in range(n) if not filled[i]]
                for i in todo:
                    idx, _, coff, clen = spans[i]
                    per_host.setdefault(chunk_hosts(layout, idx)[rank],
                                        []).append((i, Message(
                                            MsgType.CHUNK_READ, {
                                                "home": ino.host_id,
                                                "file_id": ino.file_id,
                                                "index": idx,
                                                "offset": coff,
                                                "length": clen})))

                def fetch(host: int, items) -> None:
                    resps = self._rpc_many(host, [m for _, m in items],
                                           critical=critical)
                    with cond:
                        for (slot, m), resp in zip(items, resps):
                            if resp.type is MsgType.ERROR:
                                state["errors"] += 1
                                state["failover"] = True
                                cond.notify_all()
                                continue
                            want = m.header["length"]
                            p = bytes(resp.payload)  # own the bytes NOW
                            if len(p) < want:
                                # hole OR unrepaired stale copy: fallback
                                # of last resort, never an immediate win
                                fb = fallback[slot]
                                if fb is None or len(p) > len(fb):
                                    fallback[slot] = p
                                continue
                            if not filled[slot]:
                                filled[slot] = True
                                results[slot] = p
                                state["remaining"] -= 1
                                if rank > 0:
                                    self.hedge_wins += 1
                                cond.notify_all()

                self._fanout_hosts(per_host, fetch)
            except Exception:
                # a whole-attempt failure (transport raise) is just "this
                # rank lost" for its spans: flag it so the orchestrator
                # fails over instead of letting the hedge timer run out
                with cond:
                    state["errors"] += 1
                    state["failover"] = True
            finally:
                with cond:
                    state["active"] -= 1
                    cond.notify_all()

        def launch(rank: int) -> None:
            state["active"] += 1
            threading.Thread(target=attempt, args=(rank,),
                             daemon=True).start()

        hedge = (self.hedge_delay_s if self.hedge_delay_s is not None
                 else DEFAULT_HEDGE_DELAY_S)
        with cond:
            launch(0)
            for rank in range(1, r):
                deadline = time.monotonic() + hedge
                while state["remaining"] > 0 and not state["failover"]:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    cond.wait(left)
                if state["remaining"] == 0:
                    break
                if state["failover"]:
                    state["failover"] = False
                    self.read_failovers += 1
                else:
                    self.hedged_reads += state["remaining"]
                launch(rank)
            # every rank launched (or results complete): wait out the
            # attempts that still matter, WITHOUT joining losers — a slow
            # straggler must not stall the read its hedge already won
            while state["remaining"] > 0 and state["active"] > 0:
                cond.wait()
            out: List[bytes] = []
            for i in range(n):
                if filled[i]:
                    out.append(results[i])  # type: ignore[arg-type]
                elif fallback[i] is not None:
                    want = spans[i][3]
                    fb = fallback[i]
                    out.append(fb + bytes(want - len(fb)))
                else:
                    raise err(errno.EIO,
                              f"all {r} replicas of chunk {spans[i][0]} "
                              "failed")
        return out[0] if len(out) == 1 else b"".join(out)

    def _scatter_chunks(self, ino: Inode, layout: Dict,
                        extents: List[Tuple[int, bytes]], *,
                        critical: bool, epoch: int = 0) -> None:
        """Scatter write extents to the stripe hosts' chunk objects:
        split at stripe boundaries, pipeline per host, hosts concurrent.
        The commit WRITE to the home host is the mutation: size/wseq
        advance and leases revoke there, under the file lock, so nothing
        STALE can be cached after the write is acked.  Every CHUNK_WRITE
        carries the chunk `epoch` the scatter was planned under: a stripe
        host that already saw a newer epoch (a truncate clipped in
        between) refuses it EPOCHSTALE, and the caller re-plans at the
        epoch the refusal hands back.  Visibility caveat:
        an in-place overwrite mutates existing chunk bytes before the
        commit, so a read racing the scatter can return a mix of old and
        new bytes within one call — concurrent unsynchronized read/write
        is unordered (the unstriped path's per-call atomicity is a
        single-server artifact striping gives up), but such a torn gather
        can never be SERVED later: the commit's revoke bumps the reader's
        generation, so its fill is discarded.  Replicated layouts (r>1)
        take the write-quorum fan-out path instead."""
        if min(layout.get("r", 1), len(layout["hosts"])) > 1:
            return self._scatter_replicated(ino, layout, extents,
                                            critical=critical, epoch=epoch)
        per_host: Dict[int, List[Message]] = {}
        for eoff, edata in extents:
            # zero-copy scatter: each CHUNK_WRITE carries a memoryview
            # window over the extent buffer — the vectored sendmsg path
            # (or the in-proc handler) consumes it before this call
            # returns, so header+payload are never concatenated and the
            # extent bytes are never sliced into per-chunk copies
            ev = edata if type(edata) is memoryview else memoryview(edata)
            for idx, host, coff, clen in stripe_spans(layout, eoff,
                                                      eoff + len(edata)):
                pos = idx * layout["ss"] + coff
                per_host.setdefault(host, []).append(Message(
                    MsgType.CHUNK_WRITE,
                    {"home": ino.host_id, "file_id": ino.file_id,
                     "index": idx, "offset": coff, "epoch": epoch},
                    ev[pos - eoff : pos - eoff + clen]))

        def send(host: int, msgs) -> None:
            for r in self._rpc_many(host, msgs, critical=critical):
                if r.type is MsgType.ERROR:
                    raise self._wire_err(r)

        self._fanout_hosts(per_host, send)

    def _scatter_replicated(self, ino: Inode, layout: Dict,
                            extents: List[Tuple[int, bytes]], *,
                            critical: bool, epoch: int = 0) -> None:
        """Scatter to a replicated (r>1) layout: every chunk-write unit
        fans out to ALL of its chunk's replica hosts (same zero-copy
        memoryview payload, one header dict per copy), and the scatter
        succeeds only with a write quorum of W = r//2 + 1 acks per unit —
        a majority of live copies, so a hedged read that loses the
        primary still finds a full copy, and the scrubber can tell a
        torn minority apart from the committed majority.  An EPOCHSTALE
        refusal from ANY replica outranks a quorum failure: the caller
        must re-plan at the newer epoch, not shrink the quorum."""
        n_units = 0
        per_host: Dict[int, List[Tuple[int, Message]]] = {}
        for eoff, edata in extents:
            ev = edata if type(edata) is memoryview else memoryview(edata)
            for idx, _, coff, clen in stripe_spans(layout, eoff,
                                                   eoff + len(edata)):
                pos = idx * layout["ss"] + coff
                payload = ev[pos - eoff : pos - eoff + clen]
                for host in chunk_hosts(layout, idx):
                    per_host.setdefault(host, []).append(
                        (n_units, Message(
                            MsgType.CHUNK_WRITE,
                            {"home": ino.host_id, "file_id": ino.file_id,
                             "index": idx, "offset": coff, "epoch": epoch},
                            payload)))
                n_units += 1
        r = min(layout.get("r", 1), len(layout["hosts"]))
        w = r // 2 + 1
        acks = [0] * n_units
        stale: List[Message] = []
        lock = threading.Lock()

        def send(host: int, items) -> None:
            resps = self._rpc_many(host, [m for _, m in items],
                                   critical=critical)
            with lock:
                for (unit, _), resp in zip(items, resps):
                    if resp.type is MsgType.ERROR:
                        if resp.header.get("errno") == EPOCHSTALE:
                            stale.append(resp)
                        continue
                    acks[unit] += 1

        self._fanout_hosts(per_host, send)
        if stale:
            raise self._wire_err(stale[0])
        if any(a < w for a in acks):
            raise err(errno.EIO, f"write quorum {w}/{r} not met")

    def _scatter_with_retry(self, ino: Inode, layout: Dict,
                            extents: List[Tuple[int, bytes]], *,
                            critical: bool) -> int:
        """Scatter, re-planning at the newer epoch whenever a stripe host
        refuses EPOCHSTALE (a truncate clipped between our epoch snapshot
        and the scatter landing).  Returns the epoch the scatter succeeded
        under — the epoch the commit must carry."""
        key = (ino.host_id, ino.file_id)
        for _ in range(_EPOCH_RETRIES):
            epoch = self._epoch_of(key)
            try:
                self._scatter_chunks(ino, layout, extents,
                                     critical=critical, epoch=epoch)
                return epoch
            except FSError as e:
                if e.errno != EPOCHSTALE:
                    raise
                self._note_epoch(key, getattr(e, "epoch", epoch + 1))
                self.epoch_retries += 1
        raise err(errno.EIO, "scatter kept losing epoch races")

    # ------------------------------------------------------------------
    # readahead: sequential-read detection + async cache prefill
    # ------------------------------------------------------------------
    def _maybe_readahead(self, fh: FileHandle, start: int) -> None:
        """Called after every read(): when two consecutive reads were
        sequential, schedule an asynchronous prefetch of the next window
        into the page cache.  The worker's fill is generation- and
        wseq-checked like any demand fill, so a prefetch racing a writer's
        revoke is discarded, never served."""
        sequential = start == fh.ra_next and start > 0
        fh.ra_next = fh.offset
        if not sequential:
            fh.ra_sched = fh.offset
            return
        size = self._cache.known_size(_ino_key(fh.ino))
        if size is None or fh.offset >= size:
            return
        if fh.ra_sched - fh.offset > self.readahead_window // 2:
            return  # pipeline is far enough ahead; don't fragment windows
        lo = max(fh.offset, fh.ra_sched)
        hi = min(lo + self.readahead_window, size)
        if lo >= hi:
            return
        fh.ra_sched = hi
        token = (_ino_key(fh.ino), lo, hi)
        with self._ra_lock:
            if token in self._ra_inflight:
                return
            self._ra_inflight[token] = threading.Event()
            self.readaheads += 1
        self._ra_q.put((fh, lo, hi - lo, token))

    def _ra_worker(self) -> None:
        while True:
            item = self._ra_q.get()
            if item is None:
                return
            fh, off, ln, token = item
            try:
                if not fh.pending_trunc:  # never trigger a trunc from ra
                    self._fetch_span(fh, off, ln, critical=False,
                                     record_open=False)
            except FSError:
                pass  # prefetch is best-effort; the demand read will RPC
            except Exception:
                # anything else is a BUG in the prefetch path, not an I/O
                # outcome: still swallow it (a prefetch must never take
                # the agent down) but count it where drain() reports —
                # a broken readahead path must not be able to hide forever
                # behind "the demand read worked anyway"
                with self._wb_cond:
                    self.async_errors += 1
            finally:
                with self._ra_lock:
                    ev = self._ra_inflight.pop(token, None)
                if ev is not None:
                    ev.set()  # wake demand reads parked on this window

    def _lease_request(self, key: Tuple[int, int], host_id: int,
                       h: Dict) -> Tuple[int, int, float]:
        """Ask for a read lease on this READ; snapshot the revocation
        generation and the server incarnation FIRST — fill() discards the
        response if the generation moved, and a pre-RPC incarnation
        snapshot means a restart racing the RPC yields a conservative
        stale stamp (one wasted refetch) rather than trusted-stale data.
        The third element is t0 for the grant's TTL, also stamped before
        the RPC leaves: the server starts ITS copy of the clock later (at
        grant processing), so the client's lease always dies first and an
        expired client can never serve past the server's deadline."""
        if self._cache is None:
            return 0, 0, 0.0
        h["lease"] = {"client_id": self.client_id, "cb_addr": self.cb_addr}
        return (self._cache.gen(key), self.config.version(host_id),
                time.monotonic())

    def _cached_read(self, fh: FileHandle, offset: int, length: int
                     ) -> Optional[bytes]:
        """Try to serve a read locally.  None => fall back to the RPC path.
        Clean base blocks come from the page cache (valid lease required,
        stamped by the server incarnation the config currently names);
        this agent's buffered/in-flight write-behind extents are overlaid
        on top, newest last, so read-your-writes holds WITHOUT draining."""
        if fh.pending_trunc:
            return None  # deferred O_TRUNC must reach the server first
        ino = Inode.unpack(fh.ino)
        key = _ino_key(fh.ino)
        shadow = self._shadow_extents(key, offset, length)
        if shadow is None:
            return None  # a buffered deferred-truncate is not overlayable
        extents, shadow_end = shadow
        base = self._cache.serve(key, offset, length,
                                 self.config.version(ino.host_id))
        if base is None:
            return None
        data, size = base
        if not shadow_end:
            return data
        eff_end = max(size, shadow_end)
        want_end = min(offset + length, eff_end)
        if want_end <= offset:
            return b""
        buf = bytearray(want_end - offset)  # holes read as zeros
        buf[: len(data)] = data
        for eoff, edata in extents:
            hi = min(eoff + len(edata), want_end)
            if hi > eoff:
                buf[eoff - offset : hi - offset] = edata[: hi - eoff]
        return bytes(buf)

    def _shadow_extents(self, key: Tuple[int, int], offset: int, length: int
                        ) -> Optional[Tuple[List[Tuple[int, bytes]], int]]:
        """Snapshot this agent's unacked write-behind data for one file in
        overlay order (in-flight flush jobs first, then still-buffered
        extents, which are newer), clipped to the requested span so a small
        read never copies a large dirty buffer.  Returns (extents,
        max_buffered_end) — max_buffered_end covers ALL buffered data, not
        just the span, so EOF extension is visible to reads near the end;
        0 means the file is clean.  None => state not overlayable (a handle
        owes a deferred O_TRUNC), use the drain path."""
        if not self.write_behind:
            return [], 0
        out: List[Tuple[int, bytes]] = []
        max_end = 0
        span_end = offset + length
        with self._wb_cond:
            handles = self._wb_by_ino.get(key)
            jobs = self._wb_inflight_jobs.get(key)
            if not handles and not jobs:
                return out, 0
            runs: List[_Extent] = []
            for j in jobs or ():
                if j.trunc:
                    return None
                runs.extend(j.extents)
            for fh2 in sorted(handles or (), key=lambda f: f.fd):
                if fh2.pending_trunc:
                    return None
                runs.extend(fh2.dirty)
            for e in runs:
                if e.end > max_end:
                    max_end = e.end
                lo, hi = max(e.offset, offset), min(e.end, span_end)
                if lo < hi:
                    out.append((lo, bytes(e.data[lo - e.offset
                                                 : hi - e.offset])))
        return out, max_end

    def write(self, fd: int, data: bytes) -> int:
        fh = self._fh(fd)
        if self.write_behind:
            return self._wb_write(fh, data)
        if fh.layout is not None:
            return self._striped_write(fh, data)
        ino = Inode.unpack(fh.ino)
        key = _ino_key(fh.ino)
        offset = fh.offset
        h = {"file_id": ino.file_id, "offset": offset,
             "client_id": self.client_id, **self._io_header(fh)}
        trunc = fh.pending_trunc
        if trunc:
            h["truncate"] = True
        if self._cache is not None:
            gen, ver = self._cache.gen(key), self.config.version(ino.host_id)
        resp = self._rpc(ino.host_id, Message(MsgType.WRITE, h, data))
        # cleared only on success: a failed WRITE must not silently drop the
        # deferred O_TRUNC (the retry or the eventual close still owes it)
        fh.pending_trunc = False
        if self._cache is not None:
            wseq = resp.header.get("wseq", 0)
            if trunc:
                self._cache.drop(key)  # pre-truncation blocks are dead
                self._cache.note_mutation(key, ver, wseq)
            else:
                # our write is the newest acked data for this range (the
                # server excluded our lease from its revoke fan-out); a
                # racing writer's revoke moves the generation, and wseq
                # orders it against our own concurrent writes
                self._cache.patch(key, gen, [(offset, bytes(data))],
                                  resp.header.get("size"), ver, wseq)
        fh.offset += resp.header["written"]
        return resp.header["written"]

    def _striped_write(self, fh: FileHandle, data: bytes) -> int:
        """Synchronous striped write: scatter the bytes to the stripe
        hosts' chunk objects in parallel, then publish them with ONE
        commit WRITE to the home host — which revokes other holders'
        leases and advances size/wseq under the file lock, exactly like an
        ordinary WRITE, so every page-cache invariant carries over.  A
        deferred O_TRUNC is flushed as an explicit TRUNCATE first: the
        home host must clip the old chunks on their stripe hosts before
        new bytes land, or a reclaimed range could resurface as garbage
        under a later hole."""
        self._flush_trunc(fh)
        ino = Inode.unpack(fh.ino)
        key = _ino_key(fh.ino)
        offset = fh.offset
        gen = ver = 0
        if self._cache is not None:
            gen, ver = self._cache.gen(key), self.config.version(ino.host_id)
        io_h = self._io_header(fh)
        resp = None
        for _ in range(_EPOCH_RETRIES):
            epoch = self._epoch_of(key)
            try:
                if data:
                    self._scatter_chunks(ino, fh.layout, [(offset, data)],
                                         critical=True, epoch=epoch)
                h = {"file_id": ino.file_id, "client_id": self.client_id,
                     "offset": offset, "commit": [[offset, len(data)]],
                     "epoch": epoch, **io_h}
                resp = self._rpc(ino.host_id, Message(MsgType.WRITE, h))
            except FSError as e:
                if e.errno != EPOCHSTALE:
                    raise
                # a truncate interleaved our scatter→commit: nothing was
                # published (the commit died at the epoch gate), so retry
                # the WHOLE scatter at the epoch the refusal handed back —
                # the acked result is then fully backed by the chunk store
                self._note_epoch(key, getattr(e, "epoch", epoch + 1))
                self.epoch_retries += 1
                # io_h is reused as-is: the server records the deferred
                # open BEFORE the epoch gate, but registration is an
                # idempotent set-add of the same (client, pid, fd), so
                # re-sending the record with the retry is harmless
                continue
            break
        else:
            raise err(errno.EIO, "striped write kept losing epoch races")
        self._note_epoch(key, resp.header.get("epoch"))
        if self._cache is not None:
            self._cache.patch(key, gen, [(offset, bytes(data))],
                              resp.header.get("size"), ver,
                              resp.header.get("wseq", 0))
        fh.offset += resp.header["written"]
        return resp.header["written"]

    def fsync(self, fd: int) -> None:
        """Durability barrier: drain this file's buffered writes, re-raise
        any latched flush error (CannyFS-style sync-point reporting), then
        have the server flush object data + metadata to disk (FSYNC verb).
        On a synchronous agent only the server-side FSYNC remains."""
        fh = self._fh(fd)
        if self.write_behind:
            with self._wb_cond:
                self._wb_restage(fh)
        self._wb_drain_key(_ino_key(fh.ino))
        e = self._take_latched(fh)
        if e is not None:
            raise e
        self._flush_trunc(fh)
        ino = Inode.unpack(fh.ino)
        self._rpc(ino.host_id, Message(MsgType.FSYNC, {
            "file_id": ino.file_id, **self._io_header(fh)}))

    def close(self, fd: int) -> None:
        """Returns immediately; the CLOSE RPC is issued asynchronously (§3.3).
        Under write-behind the handle's buffered extents are handed to the
        flusher and the (still-async) CLOSE is enqueued only after they
        land — close() never blocks on the flush, but a flush error already
        latched on the handle is re-raised here, the caller's last sync
        point."""
        with self._fd_lock:
            fh = self._fds.pop(fd, None)
        if fh is None:
            raise err(errno.EBADF, str(fd))
        if self.write_behind:
            self._wb_close(fh)
            return
        # open(O_TRUNC) with no intervening write(): the deferred truncate
        # never rode on a WRITE — flush it now, synchronously.  A file
        # unlinked in the meantime has nothing left to truncate; close()
        # must not raise for that.
        self._flush_trunc(fh, ignore_enoent=True)
        if fh.incomplete_open:
            return  # never touched the server: nothing to wrap up
        self._enqueue_close(fh)

    def _enqueue_close(self, fh: FileHandle) -> None:
        ino = Inode.unpack(fh.ino)
        self._close_q.put(Message(MsgType.CLOSE, {
            "host": ino.host_id, "file_id": ino.file_id,
            "client_id": self.client_id, "pid": self.pid, "fd": fh.fd}))

    def _close_worker(self) -> None:
        while True:
            msg = self._close_q.get()
            if msg is None:
                self._close_q.task_done()
                return
            try:
                host = msg.header.pop("host")
                self._rpc(host, msg, critical=False)
            except Exception:
                # best-effort wrap-up (server GC would reap on lease
                # expiry) but never silent: FSError or not, the failure is
                # latched in async_errors and surfaces through drain().
                # The try covers the whole wrap-up, not just the RPC — an
                # unexpected error before the send must not kill this
                # worker thread (drain()'s queue join would hang forever
                # on a dead consumer).
                with self._wb_cond:
                    self.async_errors += 1
            finally:
                self._close_q.task_done()

    def drain(self) -> int:
        """Block until every buffered write-behind extent has been flushed
        and every queued async CLOSE RPC has completed.  Returns the number
        of asynchronous failures recorded so far (failed async closes +
        flush errors on already-closed handles) so callers can assert a
        clean shutdown."""
        if self.write_behind:
            with self._wb_cond:
                while self._wb_by_ino or self._wb_inflight:
                    self._wb_cond.wait()
        self._close_q.join()
        with self._wb_cond:
            return self.async_errors

    # ------------------------------------------------------------------
    # write-behind pipeline: dirty buffers, per-host flushers, barriers
    # ------------------------------------------------------------------
    def _wb_write(self, fh: FileHandle, data: bytes) -> int:
        with self._wb_cond:
            self._wb_restage(fh)
            e, fh.wb_error = fh.wb_error, None
            if e is not None:
                raise e  # latched flush failure: this is the next sync point
            if not data:
                return 0
            if fh.dirty and fh.dirty[-1].end == fh.offset:
                fh.dirty[-1].data += data      # coalesce sequential appends
            else:
                fh.dirty.append(_Extent(fh.offset, bytearray(data)))
            fh.offset += len(data)
            self._wb_dirty_bytes += len(data)
            self._wb_register(fh)
            # backpressure: the dirty buffer is bounded; once the budget is
            # exceeded the writer blocks until the flushers drain below it
            while self._wb_dirty_bytes > self.dirty_budget and not self._wb_stop:
                self._wb_cond.wait()
        return len(data)

    def _wb_close(self, fh: FileHandle) -> None:
        with self._wb_cond:
            self._wb_restage(fh)
            e, fh.wb_error = fh.wb_error, None
            if e is not None:
                # broken handle: drop its buffered data and report now
                self._wb_dirty_bytes -= sum(len(x.data) for x in fh.dirty)
                fh.dirty = []
                if fh.wb_inflight:
                    # a flush is still carrying this (now dead) handle: mark
                    # it closing so a second failure lands in async_errors
                    # instead of being latched where nobody can see it
                    fh.wb_closing = True
                else:
                    self._wb_unregister(fh)
                self._wb_cond.notify_all()
                raise e
            if fh.dirty or fh.wb_inflight or fh.pending_trunc:
                fh.wb_closing = True
                if fh.dirty or fh.pending_trunc:
                    # trunc-only handles need a flush job of their own; the
                    # flusher re-reads pending_trunc at snapshot time, so a
                    # registration made stale by an in-flight flush is a no-op
                    self._wb_register(fh)
                return
        if not fh.incomplete_open:
            self._enqueue_close(fh)

    def _wb_register(self, fh: FileHandle) -> None:
        """Queue a handle for its host's flusher.  Caller holds _wb_cond."""
        host = Inode.unpack(fh.ino).host_id
        self._wb_pending.setdefault(host, {})[fh.fd] = fh
        self._wb_by_ino.setdefault(_ino_key(fh.ino), set()).add(fh)
        if host not in self._wb_flushers:
            t = threading.Thread(target=self._flusher_loop, args=(host,),
                                 daemon=True)
            self._wb_flushers[host] = t
            t.start()
        self._wb_cond.notify_all()

    def _wb_unregister(self, fh: FileHandle) -> None:
        """Drop a clean handle from the flush queues.  Caller holds _wb_cond."""
        pend = self._wb_pending.get(Inode.unpack(fh.ino).host_id)
        if pend is not None:
            pend.pop(fh.fd, None)
        key = _ino_key(fh.ino)
        s = self._wb_by_ino.get(key)
        if s is not None:
            s.discard(fh)
            if not s:
                del self._wb_by_ino[key]

    def _wb_drain_key(self, key: Tuple[int, int]) -> None:
        """Write barrier for one file: block until no handle holds buffered
        or in-flight data for it.  This is what gives read-your-writes and
        orders flushes before unlink/stat on the same object."""
        if not self.write_behind:
            return
        with self._wb_cond:
            while self._wb_by_ino.get(key):
                self._wb_cond.wait()

    def _take_latched(self, fh: FileHandle) -> Optional[FSError]:
        with self._wb_cond:
            e, fh.wb_error = fh.wb_error, None
        return e

    def _wb_restage(self, fh: FileHandle) -> None:
        """Clear a RETRYABLE latched flush error and put its stalled
        extents back on the dirty list (newer buffered data punched out
        first — restaged bytes are older and must never win an overlap).
        Called at every sync point BEFORE the latch is inspected, so a
        transient failure (dead home awaiting promotion) turns into a
        retried flush instead of a surfaced error.  A permanent latch
        (wb_retryable False) is left for the caller to re-raise.
        Caller holds _wb_cond."""
        if not fh.wb_retryable:
            return
        fh.wb_error = None
        fh.wb_retryable = False
        stalled, fh.wb_stalled = fh.wb_stalled, []
        # "newer" = buffered dirty extents AND extents riding a flush still
        # in flight — the per-host flusher is sequential, so anything in
        # flight was snapshotted after the stalled job failed.  If that
        # flight fails transiently its extents rejoin wb_stalled intact;
        # if it lands, the punched-out ranges were exactly right.
        newer = list(fh.dirty)
        for j in self._wb_inflight_jobs.get(_ino_key(fh.ino), []):
            newer.extend(j.extents)
        stalled = _subtract_extents(stalled, newer)
        if stalled:
            fh.dirty[:0] = stalled
            self._wb_dirty_bytes += sum(len(x.data) for x in stalled)
        if stalled or fh.pending_trunc:
            self._wb_register(fh)

    def _flusher_loop(self, host: int) -> None:
        """One flusher per host: snapshot every pending handle's extents
        (coalesced), flush them in per-host BATCH envelopes, repeat.  Cycles
        are sequential per host, which is what keeps one file's WRITEs in
        order even though the envelopes themselves are pipelined."""
        while True:
            with self._wb_cond:
                while not self._wb_pending.get(host) and not self._wb_stop:
                    self._wb_cond.wait()
                pend = self._wb_pending.get(host)
                if not pend:
                    return  # stopping, nothing left for this host
                jobs: List[_FlushJob] = []
                for fd in list(pend):
                    fh = pend.pop(fd)
                    extents, fh.dirty = _coalesce(fh.dirty), []
                    fh.wb_inflight = True
                    self._wb_inflight += 1
                    key = _ino_key(fh.ino)
                    gen = ver = 0
                    if self._cache is not None:
                        gen = self._cache.gen(key)
                        ver = self.config.version(host)
                    job = _FlushJob(fh, extents, fh.pending_trunc,
                                    self._io_header(fh), gen, ver)
                    # keep the snapshotted extents visible to readers until
                    # the flush lands (dirty-extent shadowing)
                    self._wb_inflight_jobs.setdefault(key, []).append(job)
                    jobs.append(job)
            self._flush_jobs(host, jobs)

    def _flush_jobs(self, host: int, jobs: List[_FlushJob]) -> None:
        """Flush one cycle's jobs for one (home) host: striped handles
        scatter-gather to the stripe hosts then commit at the home host;
        unstriped handles ride the existing per-host BATCH envelopes.
        Either way, failures map back to individual handles and every job
        is settled exactly once."""
        striped = [j for j in jobs if j.fh.layout is not None]
        plain = [j for j in jobs if j.fh.layout is None]
        try:
            if striped:
                self._flush_striped_jobs(host, striped)
            if plain:
                self._flush_plain_jobs(host, plain)
        except Exception as e:  # refresh_host, malformed response, ...
            fb = e if isinstance(e, FSError) else err(errno.EIO,
                                                      f"flush failed: {e}")
            for j in jobs:
                if j.error is None:
                    j.error, j.first_sub_failed = fb, True
        finally:
            self._complete_jobs(jobs)

    def _flush_striped_jobs(self, host: int, jobs: List[_FlushJob]) -> None:
        """Striped write-behind flush.  Per job: (1) a deferred O_TRUNC
        goes to the home host as an explicit TRUNCATE (which clips the
        chunk objects on their stripe hosts under the file lock); (2) the
        job's coalesced extents are scattered to the stripe hosts with
        per-host pipelined CHUNK_WRITE fan-outs running concurrently
        across hosts; (3) one commit WRITE per job publishes size/wseq at
        the home host — all commits of the cycle ride one BATCH envelope.
        Ordering: the flusher's cycles are sequential per home host, and
        within a cycle each job's scatter completes before its commit is
        sent, so one file's writes stay ordered exactly as on the
        unstriped path."""
        prepped: List[Optional[Tuple[_FlushJob, Message]]] = [None] * len(jobs)

        def prep(slot: int, j: _FlushJob) -> None:
            ino = Inode.unpack(j.fh.ino)
            try:
                if j.trunc:
                    resp = self._rpc(host, Message(MsgType.TRUNCATE, {
                        "file_id": ino.file_id, "size": 0,
                        "client_id": self.client_id, **j.io_h}),
                        critical=False)
                    j.io_h = {}  # the open record rode the TRUNCATE
                    j.wseq = max(j.wseq, resp.header.get("wseq", 0))
                    self._note_epoch(_ino_key(j.fh.ino),
                                     resp.header.get("epoch"))
                if j.extents:
                    j.epoch = self._scatter_with_retry(
                        ino, j.fh.layout,
                        [(e.offset, bytes(e.data)) for e in j.extents],
                        critical=False)
                    prepped[slot] = (j, Message(MsgType.WRITE, {
                        "file_id": ino.file_id, "client_id": self.client_id,
                        "offset": j.extents[0].offset,
                        "commit": [[e.offset, len(e.data)]
                                   for e in j.extents],
                        "epoch": j.epoch,
                        **j.io_h}))
            except FSError as e:
                j.error = e
                # restore-the-open-record semantics: failed before the
                # message carrying io_h could land
                j.first_sub_failed = bool(j.io_h)
            except Exception as e:
                # non-FSError (refresh_host ConnectionError, malformed
                # response, ...) on a prep THREAD would otherwise vanish
                # with the thread — and a job with no error and no commit
                # settles as flushed: silent acknowledged data loss
                j.error = err(errno.EIO, f"striped flush failed: {e}")
                j.first_sub_failed = bool(j.io_h)

        # independent files overlap their truncate+scatter sequences in
        # bounded waves; jobs on the SAME file stay in one group and run
        # in order (two handles' scatters must not interleave — fd order
        # decides overlaps, as the plain path's in-envelope order does).
        # Commits still follow every prep.
        groups: Dict[Tuple[int, int], List[Tuple[int, _FlushJob]]] = {}
        for slot, j in enumerate(jobs):
            groups.setdefault(_ino_key(j.fh.ino), []).append((slot, j))

        def prep_group(items: List[Tuple[int, _FlushJob]]) -> None:
            for slot, j in items:
                prep(slot, j)

        glist = list(groups.values())
        for base in range(0, len(glist), 8):
            wave = glist[base : base + 8]
            if len(wave) == 1:
                prep_group(wave[0])
            else:
                threads = [threading.Thread(target=prep_group, args=(g,))
                           for g in wave]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        commits = [c for c in prepped if c is not None]
        if not commits:
            return
        resps = self._rpc_batch(host, [m for _, m in commits],
                                critical=False)
        for (j, m), r in zip(commits, resps):
            if (r.type is MsgType.ERROR
                    and r.header.get("errno") == EPOCHSTALE):
                # a truncate slid between this job's scatter and its
                # commit: nothing was published, so the flusher — the only
                # party still holding the bytes — must re-scatter at the
                # new epoch rather than latch an error for data the caller
                # was already promised (write() returned long ago)
                self._note_epoch(_ino_key(j.fh.ino), r.header.get("epoch"))
                r = self._recommit_stale_job(host, j, m)
            if r.type is MsgType.ERROR:
                j.error = self._wire_err(r)
                j.first_sub_failed = bool(j.io_h)
            else:
                s = r.header.get("size")
                if s is not None and (j.new_size is None or s > j.new_size):
                    j.new_size = s
                j.wseq = max(j.wseq, r.header.get("wseq", 0))
                self._note_epoch(_ino_key(j.fh.ino), r.header.get("epoch"))

    def _recommit_stale_job(self, host: int, j: _FlushJob,
                            commit: Message) -> Message:
        """Redo one write-behind job whose commit died EPOCHSTALE:
        re-scatter its extents at the refreshed epoch and re-send the
        commit, until it lands or the retry budget is spent.  ONE flat
        budget covers scatter and commit refusals alike (a scatter refusal
        is handled inline here, not via _scatter_with_retry, so the rounds
        cannot multiply to retries²).  Returns the final (OK or ERROR)
        response for the caller's normal settling."""
        ino = Inode.unpack(j.fh.ino)
        key = _ino_key(j.fh.ino)
        extents = [(e.offset, bytes(e.data)) for e in j.extents]
        resp = wire_error(errno.EIO, "commit kept losing epoch races")
        for _ in range(_EPOCH_RETRIES):
            self.epoch_retries += 1
            epoch = self._epoch_of(key)
            try:
                self._scatter_chunks(ino, j.fh.layout, extents,
                                     critical=False, epoch=epoch)
            except FSError as e:
                if e.errno != EPOCHSTALE:
                    return wire_error(e.errno or errno.EIO, str(e))
                self._note_epoch(key, getattr(e, "epoch", epoch + 1))
                continue
            j.epoch = epoch
            commit.header["epoch"] = epoch
            resp = self._rpc_batch(host, [commit], critical=False)[0]
            if (resp.type is not MsgType.ERROR
                    or resp.header.get("errno") != EPOCHSTALE):
                return resp
            self._note_epoch(key, resp.header.get("epoch"))
        return resp

    def _flush_plain_jobs(self, host: int, jobs: List[_FlushJob]) -> None:
        """Build WRITE/TRUNCATE sub-messages for each job, pack them into
        BATCH envelopes (never splitting one handle's run across envelopes —
        pipelined frames may be serviced out of order, an envelope executes
        in order), send, and map failures back to individual handles."""
        per_job: List[List[Message]] = []
        for j in jobs:
            ino = Inode.unpack(j.fh.ino)
            subs: List[Message] = []
            if j.extents:
                for i, e in enumerate(j.extents):
                    h: Dict = {"file_id": ino.file_id, "offset": e.offset,
                               "client_id": self.client_id}
                    if i == 0:
                        h.update(j.io_h)
                        if j.trunc:
                            h["truncate"] = True
                    subs.append(Message(MsgType.WRITE, h, bytes(e.data)))
            elif j.trunc:
                subs.append(Message(MsgType.TRUNCATE, {
                    "file_id": ino.file_id, "size": 0,
                    "client_id": self.client_id, **j.io_h}))
            per_job.append(subs)
        chunks: List[List[int]] = [[]]
        n_sub = size = 0
        for idx, subs in enumerate(per_job):
            jb = sum(len(m.payload) for m in subs)
            if chunks[-1] and (n_sub + len(subs) > DEFAULT_BATCH
                               or size + jb > MAX_FLUSH_ENVELOPE_BYTES):
                chunks.append([])
                n_sub = size = 0
            chunks[-1].append(idx)
            n_sub += len(subs)
            size += jb
        sends = [(c, [m for idx in c for m in per_job[idx]])
                 for c in chunks]
        sends = [(c, flat) for c, flat in sends if flat]
        if len(sends) == 1:
            c, flat = sends[0]
            try:
                resps = self._rpc_batch(host, flat, critical=False)
            except FSError as e:
                self._fail_chunk(jobs, c, e)
            else:
                self._apply_flush_resps(jobs, c, per_job, resps)
        elif sends:
            env_resps = self._rpc_many(
                host, [pack_batch(flat) for _, flat in sends],
                critical=False)
            for (c, _), er in zip(sends, env_resps):
                if er.type is MsgType.ERROR:
                    self._fail_chunk(jobs, c, err(
                        er.header.get("errno", errno.EIO),
                        er.header.get("msg", "")))
                else:
                    self._apply_flush_resps(jobs, c, per_job,
                                            unpack_batch(er))

    @staticmethod
    def _fail_chunk(jobs: List[_FlushJob], idxs: List[int], e: FSError) -> None:
        for idx in idxs:
            jobs[idx].error = e
            jobs[idx].first_sub_failed = True

    @staticmethod
    def _apply_flush_resps(jobs: List[_FlushJob], idxs: List[int],
                           per_job: List[List[Message]],
                           resps: List[Message]) -> None:
        pos = 0
        for idx in idxs:
            n = len(per_job[idx])
            j = jobs[idx]
            for k in range(n):
                r = resps[pos + k]
                if r.type is MsgType.ERROR:
                    j.error = err(r.header.get("errno", errno.EIO),
                                  r.header.get("msg", j.fh.path))
                    j.first_sub_failed = (k == 0)
                    break
                s = r.header.get("size")
                if s is not None and (j.new_size is None or s > j.new_size):
                    j.new_size = s  # acked object size: cache-patch input
                j.wseq = max(j.wseq, r.header.get("wseq", 0))
            pos += n

    def _complete_jobs(self, jobs: List[_FlushJob]) -> None:
        """Settle a flush cycle: release dirty-byte budget, latch errors on
        live handles (or count them for closed ones), and enqueue the
        deferred async CLOSE for handles that finished flushing."""
        with self._wb_cond:
            for j in jobs:
                fh = j.fh
                fh.wb_inflight = False
                self._wb_inflight -= 1
                self._wb_dirty_bytes -= j.nbytes
                key = _ino_key(fh.ino)
                lst = self._wb_inflight_jobs.get(key)
                if lst is not None:
                    try:
                        lst.remove(j)
                    except ValueError:
                        pass
                    if not lst:
                        del self._wb_inflight_jobs[key]
                if self._cache is not None:
                    if j.error is not None or j.trunc:
                        # failed flush => server state unknown; flushed
                        # truncate => pre-trunc blocks dead.  Either way the
                        # cached clean blocks are no longer trustworthy.
                        self._cache.drop(key)
                        if j.error is None:
                            self._cache.note_mutation(key, j.ver, j.wseq)
                    elif j.extents:
                        # flushed bytes are now acked clean data: patch them
                        # into the cache so the shadow they stop providing
                        # is replaced by clean blocks (generation- and
                        # wseq-checked)
                        self._cache.patch(
                            key, j.gen,
                            [(x.offset, bytes(x.data)) for x in j.extents],
                            j.new_size, j.ver, j.wseq)
                e = j.error
                if e is not None and j.trunc_only and e.errno == errno.ENOENT:
                    # closing-handle deferred O_TRUNC after the file was
                    # unlinked: same ignore-ENOENT semantics as the
                    # synchronous close path
                    e = None
                if e is None:
                    if j.trunc:
                        fh.pending_trunc = False
                    if fh.wb_stalled and j.extents:
                        # newer bytes just LANDED: the stalled (older)
                        # extents must never overwrite them when restaged
                        fh.wb_stalled = _subtract_extents(fh.wb_stalled,
                                                          j.extents)
                else:
                    if j.first_sub_failed and "incomplete_open" in j.io_h:
                        # the deferred open record never landed: restore the
                        # flag so a later flush re-sends it and a CLOSE for
                        # a never-opened handle is skipped
                        fh.incomplete_open = True
                    if fh.wb_closing:
                        self.async_errors += 1  # nobody left to re-raise to
                    else:
                        fh.wb_error = e
                        # transient errno (host dead / awaiting promotion):
                        # keep the bytes — the next sync point restages
                        # them and the retried flush follows the promoted
                        # standby's redirect.  Anything else is permanent:
                        # the latch re-raises and the bytes are gone.
                        fh.wb_retryable = e.errno in _TRANSIENT_ERRNOS
                        if fh.wb_retryable:
                            fh.wb_stalled = _subtract_extents(
                                fh.wb_stalled, j.extents) + list(j.extents)
                if not fh.dirty:  # no new writes arrived during the flush
                    self._wb_unregister(fh)
                    if fh.wb_closing:
                        fh.wb_closing = False
                        if not fh.incomplete_open:
                            self._enqueue_close(fh)
            self._wb_cond.notify_all()

    # --- metadata ops ----------------------------------------------------
    def stat(self, path: str) -> Dict:
        node, _ = self._walk(path)
        self._wb_drain_key(_ino_key(node.ino))  # size must reflect our writes
        ino = Inode.unpack(node.ino)
        resp = self._rpc(ino.host_id, Message(MsgType.STAT, {"file_id": ino.file_id}))
        return resp.header

    def stat_cached(self, path: str) -> Dict:
        """Permission/type info straight from the cached tree — zero RPCs."""
        node, _ = self._walk(path)
        return {"ino": node.ino, "mode": node.perm.mode,
                "uid": node.perm.uid, "gid": node.perm.gid,
                "is_dir": node.perm.is_dir}

    def readdir(self, path: str) -> List[str]:
        node, _ = self._walk(path)
        if not self._access(node, R_OK):
            raise err(errno.EACCES, path)
        return sorted(self._ensure_children(node))

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        parent, name = self._walk(path, want_parent=True)
        if not self._access(parent, W_OK):
            raise err(errno.EACCES, parent.path())
        pino = Inode.unpack(parent.ino)
        target_host = self.cluster.place_dir(path)
        if target_host == pino.host_id:
            resp = self._rpc(pino.host_id, Message(MsgType.MKDIR, {
                "parent": pino.file_id, "name": name, "mode": mode,
                "uid": self.cred.uid, "gid": self.cred.gid,
                "client_id": self.client_id}))
            ino, perm_hex = resp.header["ino"], resp.header["perm"]
        else:
            # decentralized two-phase: allocate dir object on its data host,
            # then link the dentry (with the 10-byte perm) into the parent
            r1 = self._rpc(target_host, Message(MsgType.MKNOD_OBJ, {
                "is_dir": True, "mode": mode,
                "uid": self.cred.uid, "gid": self.cred.gid}))
            ino, perm_hex = r1.header["ino"], r1.header["perm"]
            self._rpc(pino.host_id, Message(MsgType.LINK_DENTRY, {
                "parent": pino.file_id, "name": name, "ino": ino,
                "perm": perm_hex, "client_id": self.client_id}))
        with self._tree_lock:
            node = TreeNode(name, ino, PermRecord.unpack(bytes.fromhex(perm_hex)),
                            parent=parent)
            self._node_index[_ino_key(node.ino)] = node
            # children stays None: the first use LOOKUP_DIRs, which registers
            # this client in the server's watcher list (else invalidations
            # from other clients' creates would never reach us)
            if parent.children is not None:
                parent.children[name] = node

    def unlink(self, path: str) -> None:
        parent, name = self._walk(path, want_parent=True)
        if not self._access(parent, W_OK):
            raise err(errno.EACCES, parent.path())
        target = (parent.children or {}).get(name)
        if target is not None:
            # order buffered writes BEFORE the unlink: a flush racing the
            # UNLINK would either resurrect the object or fail with ENOENT
            self._wb_drain_key(_ino_key(target.ino))
        pino = Inode.unpack(parent.ino)
        self._rpc(pino.host_id, Message(MsgType.UNLINK, {
            "parent": pino.file_id, "name": name, "client_id": self.client_id}))
        if target is not None:
            if self._cache is not None:
                # the server dropped its whole lease table for the dead
                # file; forget our side too (blocks, grant, stamp)
                self._cache.forget(_ino_key(target.ino))
            with self._epoch_lock:  # dead file_ids are never reused
                self._epochs.pop(_ino_key(target.ino), None)
        with self._tree_lock:
            if parent.children:
                dropped = parent.children.pop(name, None)
                if dropped is not None:
                    self._forget_node(dropped)

    def chmod(self, path: str, mode: int) -> None:
        parent, name = self._walk(path, want_parent=True)
        pino = Inode.unpack(parent.ino)
        node = (parent.children or {}).get(name)
        if node is not None and self.cred.uid not in (0, node.perm.uid):
            raise err(errno.EPERM, path)
        self._rpc(pino.host_id, Message(MsgType.CHMOD, {
            "parent": pino.file_id, "name": name, "mode": mode}))

    def chown(self, path: str, uid: int, gid: int) -> None:
        parent, name = self._walk(path, want_parent=True)
        if self.cred.uid != 0:
            raise err(errno.EPERM, path)
        pino = Inode.unpack(parent.ino)
        self._rpc(pino.host_id, Message(MsgType.CHOWN, {
            "parent": pino.file_id, "name": name, "uid": uid, "gid": gid}))

    def setacl(self, path: str, acl: Optional[List]) -> None:
        """Replace a file/dir's ACL ([kind, id, allow, deny] entries; None
        or [] clears it).  Owner-or-root, like chmod; the server's §3.4
        two-phase guarantees every cached copy of the old ACL is
        invalidated before the new one applies."""
        acl = validate_acl(acl)
        parent, name = self._walk(path, want_parent=True)
        node = (parent.children or {}).get(name)
        if node is not None and self.cred.uid not in (0, node.perm.uid):
            raise err(errno.EPERM, path)
        pino = Inode.unpack(parent.ino)
        self._rpc(pino.host_id, Message(MsgType.SETACL, {
            "parent": pino.file_id, "name": name, "acl": acl}))

    def getacl(self, path: str) -> Optional[List]:
        """The ACL as this client's cache sees it (0 RPCs warm — the same
        dentry data access checks run against)."""
        node, _ = self._walk(path)
        return node.acl

    def setgroups(self, uid: int, gids: List[int]) -> None:
        """Replace `uid`'s extra group memberships in the cluster table
        (root only, like chown).  Blocking invalidation of every client
        holding the table happens before the change applies."""
        if self.cred.uid != 0:
            raise err(errno.EPERM, f"setgroups uid={uid}")
        authority = Inode.unpack(self.root.ino).host_id
        self._rpc(authority, Message(MsgType.SETGROUPS, {
            "uid": uid, "gids": list(gids)}))

    def groups(self) -> Dict[int, List[int]]:
        """The cluster group table (cached copy; fetches once if cold)."""
        return dict(self._group_table())

    def rename(self, path: str, new_name: str) -> None:
        parent, name = self._walk(path, want_parent=True)
        if not self._access(parent, W_OK):
            raise err(errno.EACCES, parent.path())
        pino = Inode.unpack(parent.ino)
        self._rpc(pino.host_id, Message(MsgType.RENAME, {
            "parent": pino.file_id, "old": name, "new": new_name,
            "client_id": self.client_id}))
        with self._tree_lock:
            if parent.children and name in parent.children:
                n = parent.children.pop(name)
                n.name = new_name
                parent.children[new_name] = n

    # --- helpers -----------------------------------------------------------
    def _fh(self, fd: int) -> FileHandle:
        with self._fd_lock:
            fh = self._fds.get(fd)
        if fh is None:
            raise err(errno.EBADF, str(fd))
        return fh

    def warm(self, path: str) -> None:
        """Pre-walk a directory chain to populate the cached tree."""
        node, _ = self._walk(path)
        if node.perm.is_dir:
            self._ensure_children(node)

    def cache_stats(self) -> Optional[Dict[str, int]]:
        """Page-cache counters (hits/misses/evictions/revocations/bytes),
        plus the readahead windows issued, or None when the agent runs
        without a read cache."""
        if self._cache is None:
            return None
        s = self._cache.stats()
        s["readaheads"] = self.readaheads
        return s

    def scrub(self) -> Dict[str, int]:
        """Trigger one scrub pass on EVERY host (the on-demand SCRUB verb)
        and aggregate the counts.  After a clean pass over a quiesced
        cluster there are zero orphaned chunks, every chunk store matches
        its home-host layouts, and each home's chunk_reap_failures debt is
        back to zero."""
        totals = Counter()
        for host in self.config.hosts():
            resp = self._rpc(host, Message(MsgType.SCRUB, {}))
            for k, v in resp.header.items():
                if isinstance(v, int):
                    totals[k] += v
        return dict(totals)

    # ------------------------------------------------------------------
    # bulk paths: batched RPCs + bulk namespace prefetch
    # ------------------------------------------------------------------
    def warm_tree(self, path: str = "/", *, batch_size: int = DEFAULT_BATCH
                  ) -> int:
        """Bulk namespace prefetch on the LOOKUP_TREE verb: pull the whole
        subtree under `path` — dentries + 10-byte perm records for every
        directory — in O(rounds x hosts) RPCs instead of one LOOKUP_DIR per
        directory.  Each server expands the locally-owned part of the
        subtree up to MAX_TREE_DEPTH and hands back a frontier of
        directories it could not descend (foreign host / depth bound);
        frontier nodes are fetched in per-host BATCH frames until none
        remain.  Every prefetched directory registers this client as a
        watcher server-side, so §3.4 invalidations keep working.

        Returns the number of directories warmed."""
        node, _ = self._walk(path)
        if not node.perm.is_dir:
            return 0
        nodes: Dict[Tuple[int, int], TreeNode] = {_ino_key(node.ino): node}
        seen = {_ino_key(node.ino)}
        frontier: List[int] = [node.ino]
        warmed = 0
        while frontier:
            by_host: Dict[int, List[Message]] = {}
            for ino in frontier:
                i = Inode.unpack(ino)
                by_host.setdefault(i.host_id, []).append(
                    Message(MsgType.LOOKUP_TREE, {
                        "file_id": i.file_id, "depth": MAX_TREE_DEPTH,
                        "client_id": self.client_id, "cb_addr": self.cb_addr}))
            next_frontier: List[int] = []
            for host, msgs in by_host.items():
                for chunk in _chunks(msgs, batch_size):
                    gens = self._gen_snapshot()
                    for r in self._rpc_batch(host, chunk):
                        if r.type is MsgType.ERROR:
                            continue  # e.g. dir unlinked mid-prefetch
                        with self._tree_lock:
                            self._note_gver(r.header.get("gver"))
                        for d in r.header["dirs"]:
                            n = nodes.get(_ino_key(d["ino"]))
                            if n is None:
                                continue
                            self._merge_dir(n, d, gens=gens)
                            warmed += 1
                            for child in (n.children or {}).values():
                                if child.perm.is_dir:  # only dirs are ever
                                    nodes.setdefault(   # looked up again
                                        _ino_key(child.ino), child)
                        for fino in r.header["frontier"]:
                            k = _ino_key(fino)
                            if k in nodes and k not in seen:
                                seen.add(k)
                                next_frontier.append(fino)
            frontier = next_frontier
        return warmed

    def _warm_dirs(self, dir_paths, *, batch_size: int = DEFAULT_BATCH) -> None:
        """Populate the cached tree for many directories, level by level,
        with one BATCH of LOOKUP_DIRs per (level, host) — O(depth x hosts)
        RPCs for an arbitrary set of directories.  Missing components are
        skipped silently; the subsequent per-path operation reports ENOENT."""
        levels: Dict[int, set] = {}
        for p in dir_paths:
            parts = [x for x in p.split("/") if x]
            for i in range(len(parts)):
                levels.setdefault(i + 1, set()).add("/" + "/".join(parts[: i + 1]))
        with self._tree_lock:
            root_cold = self.root.children is None or not self.root.valid
        if root_cold:
            self._fetch_dir(self.root)
        node_of: Dict[str, TreeNode] = {"/": self.root}
        for lvl in sorted(levels):
            to_fetch: Dict[int, List[Tuple[TreeNode, Message]]] = {}
            for prefix in sorted(levels[lvl]):
                parent_prefix, _, name = prefix.rpartition("/")
                parent = node_of.get(parent_prefix or "/")
                if parent is None or parent.children is None:
                    continue
                child = parent.children.get(name)
                if child is None or not child.perm.is_dir:
                    continue
                node_of[prefix] = child
                if child.children is None or not child.valid:
                    ino = Inode.unpack(child.ino)
                    to_fetch.setdefault(ino.host_id, []).append(
                        (child, Message(MsgType.LOOKUP_DIR, {
                            "file_id": ino.file_id, "client_id": self.client_id,
                            "cb_addr": self.cb_addr})))
            for host, items in to_fetch.items():
                for chunk in _chunks(items, batch_size):
                    # this chunk's dir set is known: snapshot only its keys
                    # (the full-map copy is reserved for LOOKUP_TREE, whose
                    # response set is unknown in advance)
                    keys = [_ino_key(dnode.ino) for dnode, _ in chunk]
                    with self._tree_lock:
                        gens = {k: self._inval_gen.get(k, 0) for k in keys}
                    resps = self._rpc_batch(host, [m for _, m in chunk])
                    for (dnode, _), r in zip(chunk, resps):
                        if r.type is not MsgType.ERROR:
                            self._merge_dir(dnode, r.header, gens=gens)

    def open_many(self, paths: List[str], flags: int = 0, mode: int = 0o644,
                  *, batch_size: int = DEFAULT_BATCH) -> List[int]:
        """Bulk open(): warm every parent directory with batched LOOKUP_DIRs,
        then run each open locally (zero per-file RPCs).  With O_CREAT,
        missing files are created in per-host CREATE batches — each batched
        CREATE still blocks on watcher invalidation acks server-side, so
        §3.4 strong consistency is untouched."""
        self._warm_dirs({p.rpartition("/")[0] or "/" for p in paths},
                        batch_size=batch_size)
        if flags & O_CREAT:
            self._create_missing(paths, mode, batch_size=batch_size)
        fds: List[int] = []
        try:
            for p in paths:
                fds.append(self.open(p, flags, mode))
            return fds
        except Exception:
            # all-or-nothing: drop the partial fd list (none of these fds
            # ever reached the server — incomplete_open — so a local pop is
            # a complete cleanup, and no deferred truncate fires)
            with self._fd_lock:
                for fd in fds:
                    self._fds.pop(fd, None)
            raise

    def _create_missing(self, paths: List[str], mode: int, *,
                        batch_size: int) -> None:
        by_host: Dict[int, List[Tuple[TreeNode, str, Message]]] = {}
        for p in paths:
            parent, name = self._walk(p, want_parent=True)
            if name is None:
                raise err(errno.EISDIR, p)
            if name in (parent.children or {}):
                continue
            if not self._access(parent, W_OK):
                raise err(errno.EACCES, f"cannot create in {parent.path()}")
            pino = Inode.unpack(parent.ino)
            by_host.setdefault(pino.host_id, []).append(
                (parent, name, self._create_msg(pino, name, mode, p)))
        for host, items in by_host.items():
            for chunk in _chunks(items, batch_size):
                resps = self._rpc_batch(host, [m for _, _, m in chunk])
                for (parent, name, _), r in zip(chunk, resps):
                    if r.type is MsgType.ERROR:
                        raise err(r.header.get("errno", errno.EIO),
                                  r.header.get("msg", name))
                    self._install_child(parent, name, r.header)

    def read_many(self, fds: List[int], n: int = -1,
                  *, batch_size: int = DEFAULT_BATCH) -> List[bytes]:
        """Bulk read(): one BATCH frame per (host, batch_size) chunk instead
        of one READ RPC per fd.  Deferred open records (§3.3) piggyback on
        the sub-messages exactly as they would on individual READs.  With
        the page cache enabled, warm fds are served locally and only the
        misses ride the batch; their responses refill the cache."""
        length = n if n >= 0 else (1 << 31)
        results: List[bytes] = [b""] * len(fds)
        # a duplicated fd needs offset chaining (read #2 starts where #1
        # ended, unknown until the response) — those go through sequential
        # read(); distinct fds batch freely
        dup_fds = {fd for fd, c in Counter(fds).items() if c > 1}
        fhs: Dict[int, FileHandle] = {}
        # per miss: (result slot, (gen, incarnation) snapshot, ino key, msg)
        by_host: Dict[int, List[Tuple[int, Tuple[int, int], Tuple[int, int],
                                      Message]]] = {}
        # two-phase so a failure leaves NO offset advanced: gather every
        # sub-response first, then apply results + offsets only if the
        # whole bulk read succeeded — otherwise a caller retrying after the
        # raise would silently skip the chunks that had already landed
        gathered: List[Tuple[int, bytes]] = []
        gather_lock = threading.Lock()
        striped_misses: List[Tuple[int, FileHandle]] = []
        for i, fd in enumerate(fds):
            if fd in dup_fds:
                continue
            fh = self._fh(fd)
            fhs[i] = fh
            if self._cache is not None:
                data = self._cached_read(fh, fh.offset, length)
                if data is not None:
                    gathered.append((i, data))  # cache install not needed
                    continue
            key = _ino_key(fh.ino)
            self._wb_drain_key(key)
            self._flush_trunc(fh)
            if fh.layout is not None:
                # striped files carry their own multi-host fan-out: they
                # go through the single fetch path (which still fills the
                # cache), collected here and run concurrently below — one
                # at a time would serialize k full fan-out latencies
                striped_misses.append((i, fh))
                continue
            ino = Inode.unpack(fh.ino)
            h = {"file_id": ino.file_id, "offset": fh.offset,
                 "length": length, **self._io_header(fh)}
            snap = self._lease_request(key, ino.host_id, h)
            by_host.setdefault(ino.host_id, []).append(
                (i, snap, key, Message(MsgType.READ, h)))

        def drain_host(host: int, items) -> None:
            for chunk in _chunks(items, batch_size):
                resps = self._rpc_batch(host, [m for _, _, _, m in chunk])
                for (i, snap, key, m), r in zip(chunk, resps):
                    if r.type is MsgType.ERROR:
                        raise err(r.header.get("errno", errno.EIO),
                                  r.header.get("msg", ""))
                    if self._cache is not None and r.header.get("lease"):
                        off = m.header["offset"]
                        ttl = r.header.get("lease_ttl_ms")
                        self._cache.fill(key, snap[0], off, r.payload,
                                         r.header.get("size",
                                                      off + len(r.payload)),
                                         snap[1], r.header.get("wseq", 0),
                                         expires=(snap[2] + ttl / 1000.0)
                                         if ttl is not None else None)
                    with gather_lock:
                        # batch sub-payloads are views into the envelope
                        # frame; these escape to the caller — materialize
                        gathered.append((i, bytes(r.payload)))

        # hosts are independent servers: drain them concurrently (each fd
        # belongs to exactly one host, so no slot is shared)
        self._fanout_hosts(by_host, drain_host)
        if striped_misses:
            # striped files' per-file fan-outs overlap in bounded waves,
            # mirroring the unstriped hosts' concurrent drains above
            fails: List[BaseException] = []

            def fetch_striped(i: int, fh: FileHandle) -> None:
                try:
                    data = self._fetch_span(fh, fh.offset, length)
                    with gather_lock:
                        gathered.append((i, data))
                except BaseException as e:
                    fails.append(e)

            for base in range(0, len(striped_misses), 8):
                wave = striped_misses[base : base + 8]
                if len(wave) == 1:
                    fetch_striped(*wave[0])
                else:
                    ts = [threading.Thread(target=fetch_striped,
                                           args=(i, fh)) for i, fh in wave]
                    for t in ts:
                        t.start()
                    for t in ts:
                        t.join()
            if fails:
                raise fails[0]
        # duplicated fds: chained preads (no offset mutation) gathered
        # BEFORE anything is applied, so a raise anywhere leaves every
        # offset untouched
        dup_gathered: List[Tuple[int, bytes]] = []
        dup_final: Dict[int, int] = {}  # fd -> offset after its chain
        for dfd in dup_fds:
            fh = self._fh(dfd)
            self._wb_drain_key(_ino_key(fh.ino))
            self._flush_trunc(fh)
            off = fh.offset
            for i, fd in enumerate(fds):
                if fd != dfd:
                    continue
                payload = self.pread(dfd, length, off)
                dup_gathered.append((i, payload))
                off += len(payload)
            dup_final[dfd] = off
        for i, payload in gathered:
            results[i] = payload
            fhs[i].offset += len(payload)
        for i, payload in dup_gathered:
            results[i] = payload
        for dfd, off in dup_final.items():
            self._fh(dfd).offset = off
        return results

    def shutdown(self) -> None:
        self.drain()
        with self._wb_cond:
            self._wb_stop = True
            self._wb_cond.notify_all()
        self._close_q.put(None)
        if self._ra_q is not None:
            self._ra_q.put(None)
        self.transport.shutdown(self.cb_addr)

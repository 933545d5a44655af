"""BLib — the user-facing BuffetFS library (paper §3.1).

In the paper BLib is an LD_PRELOAD-style dynamic library intercepting POSIX
I/O and redirecting it to the node's BAgent.  Here it is an explicit Python
facade with POSIX file semantics over a `BAgent`; framework code (data
pipeline, checkpointing) talks to this API only, so the storage backend is
swappable (BuffetFS / Lustre-Normal sim / Lustre-DoM sim) — exactly the three
groups of the paper's evaluation.
"""
from __future__ import annotations

import errno
from typing import Iterator, List, Optional

from .bagent import BAgent
from .perms import O_CREAT, O_RDONLY, O_RDWR, O_TRUNC, O_WRONLY, err


class BuffetFile:
    """File-object wrapper over a BAgent fd."""

    def __init__(self, lib: "BLib", fd: int, path: str) -> None:
        self._lib = lib
        self.fd = fd
        self.path = path
        self._closed = False

    def read(self, n: int = -1) -> bytes:
        return self._lib.agent.read(self.fd, n)

    def pread(self, n: int, offset: int) -> bytes:
        return self._lib.agent.pread(self.fd, n, offset)

    def write(self, data: bytes) -> int:
        return self._lib.agent.write(self.fd, data)

    def fsync(self) -> None:
        """Durability barrier: block until every buffered write of this file
        has been flushed AND made stable server-side (FSYNC verb).  On a
        write-behind agent this is also where latched flush errors surface."""
        self._lib.agent.fsync(self.fd)

    def close(self) -> None:
        if not self._closed:
            self._lib.agent.close(self.fd)
            self._closed = True

    def __enter__(self) -> "BuffetFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_MODE_FLAGS = {
    "rb": O_RDONLY, "r": O_RDONLY,
    "wb": O_WRONLY | O_CREAT | O_TRUNC, "w": O_WRONLY | O_CREAT | O_TRUNC,
    "r+b": O_RDWR, "ab": O_WRONLY | O_CREAT,
}


class BLib:
    """POSIX-like convenience API over a BAgent."""

    def __init__(self, agent: BAgent) -> None:
        self.agent = agent

    # --- file objects ----------------------------------------------------
    def open(self, path: str, mode: str = "rb", perm: int = 0o644) -> BuffetFile:
        flags = _MODE_FLAGS.get(mode)
        if flags is None:
            raise err(errno.EINVAL, f"mode {mode!r}")
        fd = self.agent.open(path, flags, perm)
        return BuffetFile(self, fd, path)

    # --- whole-file helpers (the framework's hot path) --------------------
    def read_file(self, path: str) -> bytes:
        """Whole-file read.  On an agent with the lease-consistent page
        cache (``BAgent(read_cache=True)``) a warm re-read costs ZERO
        critical-path RPCs — open() checks permissions locally, the data
        comes from cached blocks, and close() never touched the server."""
        with self.open(path, "rb") as f:
            return f.read()

    def cache_stats(self) -> Optional[dict]:
        """Page-cache counters of the underlying agent (None if disabled)."""
        return self.agent.cache_stats()

    def read_files(self, paths: List[str]) -> List[bytes]:
        """Bulk whole-file read over the agent's batched open/read path:
        O(depth + hosts) RPCs for the lot instead of one per file."""
        fds = self.agent.open_many(list(paths), O_RDONLY)
        try:
            return self.agent.read_many(fds)
        finally:
            for fd in fds:
                self.agent.close(fd)

    def warm_tree(self, path: str = "/") -> int:
        """Prefetch the whole namespace subtree under `path` (bulk
        LOOKUP_TREE); returns the number of directories warmed."""
        return self.agent.warm_tree(path)

    def write_file(self, path: str, data: bytes, perm: int = 0o644) -> int:
        with self.open(path, "wb", perm) as f:
            return f.write(data)

    def write_files(self, paths: List[str], blobs: List[bytes],
                    perm: int = 0o644) -> int:
        """Bulk whole-file write: batched creates via open_many (per-host
        CREATE BATCHes), then per-file writes — which a write-behind agent
        buffers and flushes off the critical path in coalesced per-host
        batches.  Returns the total bytes written."""
        fds = self.agent.open_many(list(paths), O_WRONLY | O_CREAT | O_TRUNC,
                                   perm)
        total = 0
        try:
            for fd, blob in zip(fds, blobs):
                total += self.agent.write(fd, blob)
        finally:
            for fd in fds:
                self.agent.close(fd)
        return total

    # --- namespace ---------------------------------------------------------
    def mkdir(self, path: str, mode: int = 0o755) -> None:
        self.agent.mkdir(path, mode)

    def makedirs(self, path: str, mode: int = 0o755) -> None:
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            cur += "/" + p
            try:
                self.agent.mkdir(cur, mode)
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise

    def listdir(self, path: str) -> List[str]:
        return self.agent.readdir(path)

    def exists(self, path: str) -> bool:
        try:
            self.agent.stat_cached(path)
            return True
        except OSError:
            return False

    def layout(self, path: str) -> Optional[dict]:
        """The file's stripe layout ({"ss": stripe_size, "hosts": [...]})
        straight from the cached dentry — zero RPCs — or None for a
        single-host file.  hosts[0] is the coherence home."""
        node, _ = self.agent._walk(path)
        return node.layout

    def io_stats(self) -> dict:
        """RPC counters of the underlying agent (critical path, per-type,
        per-host fan-out) — what the paper benchmarks report on — plus the
        agent's epoch-retry, failover-retry and hedged-read counts and, under
        ``servers``, each BServer's health counters: forced lease breaks,
        outstanding unlink chunk-reap failures (orphan debt the scrubber
        drains back to zero), EPOCHSTALE rejections served, and the
        replication/failover block from ``BServer.repl_stats()`` (shipping
        lag, lease-TTL waits, promotion fences)."""
        snap = self.agent.stats.snapshot()
        snap["epoch_retries"] = self.agent.epoch_retries
        snap["failover_retries"] = self.agent.failover_retries
        snap["failover_redirects"] = self.agent.failover_redirects
        snap["hedged_reads"] = self.agent.hedged_reads
        snap["hedge_wins"] = self.agent.hedge_wins
        snap["read_failovers"] = self.agent.read_failovers
        servers = getattr(self.agent.cluster, "servers", None)
        if servers:
            snap["servers"] = {
                # buffetlint: ignore[CNT001] lease_breaks_forced is pinned
                # at zero BY DESIGN (TTL-bounded leases wait out
                # unacked revokes instead of force-breaking); the fig11/13
                # gates assert it stays 0, so it is surfaced but must
                # never gain an increment site
                hid: {"lease_breaks_forced": srv.lease_breaks_forced,
                      "chunk_reap_failures": srv.chunk_reap_failures,
                      "epoch_rejects": srv.epoch_rejects,
                      "scrub_failures": srv.scrub_failures,
                      "under_replicated": srv.under_replicated,
                      "repaired_chunks": srv.repaired_chunks,
                      **srv.repl_stats()}
                for hid, srv in servers.items()
            }
        return snap

    def promote(self, dead_host_id: int) -> int:
        """Admin failover: promote the standby of a dead home host and
        re-point this client's cluster config at the new incarnation."""
        return self.agent.cluster.promote(dead_host_id)

    def scrub(self) -> dict:
        """Run one on-demand scrub pass on every host and return the
        aggregated counts (orphans_reaped, chunks_clipped, bytes_clipped,
        scrub_errors, plus the standing epoch_rejects /
        chunk_reap_failures counters summed across hosts)."""
        return self.agent.scrub()

    def stat(self, path: str) -> dict:
        return self.agent.stat(path)

    def unlink(self, path: str) -> None:
        self.agent.unlink(path)

    def chmod(self, path: str, mode: int) -> None:
        self.agent.chmod(path, mode)

    def chown(self, path: str, uid: int, gid: int) -> None:
        self.agent.chown(path, uid, gid)

    def setacl(self, path: str, acl) -> None:
        """Replace `path`'s ACL: a list of [kind, id, allow, deny] entries
        (kind "u"/"g", allow/deny rwx masks), or None to clear it."""
        self.agent.setacl(path, acl)

    def getacl(self, path: str):
        return self.agent.getacl(path)

    def setgroups(self, uid: int, gids) -> None:
        """Replace `uid`'s extra group memberships in the cluster-wide
        group table (root only)."""
        self.agent.setgroups(uid, list(gids))

    def groups(self) -> dict:
        return self.agent.groups()

    def rename(self, path: str, new_name: str) -> None:
        self.agent.rename(path, new_name)

    def walk_files(self, path: str) -> Iterator[str]:
        for name in self.listdir(path):
            child = path.rstrip("/") + "/" + name
            if self.agent.stat_cached(child)["is_dir"]:
                yield from self.walk_files(child)
            else:
                yield child

"""Lustre-Normal and Lustre-DoM protocol simulations (paper §4 test groups).

Both baselines run over the SAME BServer storage and transport as BuffetFS,
so the only difference measured is the *protocol* — which is precisely the
paper's experimental comparison:

* **Lustre-Normal**: a centralized MDS (host 0) owns the namespace.  Every
  `open()` costs one blocking OPEN_RECORD RPC to the MDS (permission check +
  opened-file record + layout), regardless of dentry caching; data RPCs go to
  the OSS that stores the object; `close()` is async to the MDS.
  => ≥2 critical-path RPCs per small-file access, and the MDS serializes all
  opens (the Fig. 4 bottleneck).

* **Lustre-DoM** (Data on MDT): like Lustre-Normal, but small files live ON
  the MDS and `open()` returns their data inline (READ_INLINE), so the read
  path is 1 RPC — at the price of pushing both metadata AND data traffic
  through the single MDS, and no benefit for writes (paper §5).

Clients cache dentries after access (the paper notes Lustre keeps valid
directory entries client-side), so path resolution costs are identical to
BuffetFS — isolating the open()-RPC difference.

Neither baseline caches file DATA client-side: every read() pays at least
one RPC no matter how recently the file was read (DoM's inline payload is
bound to one open(), not a coherent cache — a warm re-open still costs the
READ_INLINE round trip).  This is the deliberate contrast to BuffetFS's
lease-consistent page cache, where a warm read is served locally with zero
critical-path RPCs (`benchmarks/fig7_readcache.py`).
"""
from __future__ import annotations

import errno
import itertools
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .cluster import BuffetCluster
from .inode import Inode
from .perms import (Credentials, O_CREAT, O_TRUNC, PermRecord, X_OK,
                    access_ok, err, flags_to_access)
from .service import SERVER_OPS
from .wire import Message, MsgType, RpcStats, error, ok

_counter = itertools.count()

MDS = 0  # host 0 plays the MDS role for the baselines


# ---------------------------------------------------------------------------
# Baseline server-side verbs, registered into the shared service-layer
# registry (repro_torch.core.service.SERVER_OPS).  They execute on a BServer —
# identical storage to BuffetFS — but belong to the Lustre protocol
# simulations, so they live here rather than inside BServer.
# ---------------------------------------------------------------------------

@SERVER_OPS.register(MsgType.OPEN_RECORD)
def _op_open_record(server, h, _p) -> Message:
    """Lustre-Normal MDS open(): perm data + open-state record in one RPC."""
    parent, name = h["parent"], h["name"]
    with server._lock:
        pdir = server._dirs[parent]
        if name not in pdir:
            return error(errno.ENOENT, name)
        e = pdir[name]
        fid = Inode.unpack(e.ino).file_id
        server._opened.setdefault(fid, set()).add(
            (h["client_id"], h["pid"], h["fd"]))
        size = server._meta[fid].size if fid in server._meta else 0
    return ok({"ino": e.ino, "perm": e.perm.pack().hex(), "size": size})


@SERVER_OPS.register(MsgType.READ_INLINE)
def _op_read_inline(server, h, _p) -> Message:
    """Lustre-DoM open(): like OPEN_RECORD but small-file data rides along."""
    resp = _op_open_record(server, h, _p)
    if resp.type is not MsgType.OK:
        return resp
    fid = Inode.unpack(resp.header["ino"]).file_id
    if fid in server._meta:
        # size + data from the backing file under the per-file lock, like
        # _op_read: an unlocked read races a concurrent WRITE and would
        # hand the client torn half-written inline contents
        with server._file_lock(fid):
            try:
                with open(server._obj_path(fid), "rb") as f:
                    size = os.fstat(f.fileno()).st_size
                    resp.header["size"] = size
                    if size <= server.dom_limit:
                        resp.payload = f.read()
                        resp.header["inline"] = True
            except FileNotFoundError:
                pass
    return resp


@dataclass
class _LFile:
    fd: int
    ino: int
    flags: int
    path: str
    offset: int = 0
    size: int = 0
    inline: Optional[bytes] = None  # DoM: data returned by open()
    pending_trunc: bool = False


class LustreNormalClient:
    """Lustre-Normal protocol simulation with client-side dentry cache."""

    dom = False

    def __init__(self, cluster: BuffetCluster, *, cred: Credentials = Credentials(),
                 pid: int = 1) -> None:
        self.cluster = cluster
        self.transport = cluster.transport
        self.config = cluster.config
        self.cred = cred
        self.pid = pid
        self.client_id = f"lustre-{next(_counter)}"
        self.stats = RpcStats()
        self._dcache: Dict[str, Tuple[int, PermRecord]] = {}  # path -> (ino, perm)
        self._fds: Dict[int, _LFile] = {}
        self._next_fd = 3
        self._lock = threading.Lock()
        self._close_q: "queue.Queue[Optional[Message]]" = queue.Queue()
        threading.Thread(target=self._close_worker, daemon=True).start()

    # --- plumbing ---------------------------------------------------------
    def _rpc(self, host: int, msg: Message, *, critical: bool = True) -> Message:
        msg.header["ver"] = self.config.version(host)
        resp = self.transport.request(self.config.addr(host), msg,
                                      critical=critical, stats=self.stats)
        if resp.type is MsgType.ERROR:
            raise err(resp.header.get("errno", errno.EIO), resp.header.get("msg", ""))
        return resp

    def _resolve_parent(self, path: str) -> Tuple[int, str]:
        """Resolve the parent directory fileID (on the MDS) using the dentry
        cache; LOOKUP_DIR on the MDS per uncached directory."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise err(errno.EISDIR, path)
        cur = ""
        fid = Inode.unpack(self.cluster.root_ino).file_id
        for comp in parts[:-1]:
            cur += "/" + comp
            hit = self._dcache.get(cur)
            if hit is None:
                resp = self._rpc(MDS, Message(MsgType.LOOKUP_DIR, {"file_id": fid}))
                for e in resp.header["entries"]:
                    p = cur.rsplit("/", 1)[0] + "/" + e["name"]
                    self._dcache[p if p.startswith("/") else "/" + p] = (
                        e["ino"], PermRecord.unpack(bytes.fromhex(e["perm"])))
                hit = self._dcache.get(cur)
                if hit is None:
                    raise err(errno.ENOENT, cur)
            ino, perm = hit
            if not access_ok(perm, self.cred, X_OK):
                raise err(errno.EACCES, cur)
            fid = Inode.unpack(ino).file_id
        return fid, parts[-1]

    # --- POSIX ops ----------------------------------------------------------
    def open(self, path: str, flags: int = 0, mode: int = 0o644) -> int:
        parent_fid, name = self._resolve_parent(path)
        with self._lock:
            fd = self._next_fd
            self._next_fd += 1
        if flags & O_CREAT:
            resp = self._rpc(MDS, Message(MsgType.CREATE, {
                "parent": parent_fid, "name": name, "mode": mode,
                "uid": self.cred.uid, "gid": self.cred.gid,
                "client_id": self.client_id}))
            ino, size, inline = resp.header["ino"], 0, None
        else:
            # THE RPC BuffetFS eliminates: blocking MDS open on every access
            verb = MsgType.READ_INLINE if self.dom else MsgType.OPEN_RECORD
            resp = self._rpc(MDS, Message(verb, {
                "parent": parent_fid, "name": name,
                "client_id": self.client_id, "pid": self.pid, "fd": fd}))
            perm = PermRecord.unpack(bytes.fromhex(resp.header["perm"]))
            if not access_ok(perm, self.cred, flags_to_access(flags)):
                raise err(errno.EACCES, path)
            ino, size = resp.header["ino"], resp.header["size"]
            # retained past the RPC (served from later read()s): own the
            # bytes, never a view over the transport's frame
            inline = bytes(resp.payload) if resp.header.get("inline") else None
        with self._lock:
            self._fds[fd] = _LFile(fd=fd, ino=ino, flags=flags, path=path,
                                   size=size, inline=inline,
                                   pending_trunc=bool(flags & O_TRUNC))
        return fd

    def _flush_trunc(self, fh: _LFile, *, ignore_enoent: bool = False) -> None:
        if not fh.pending_trunc:
            return
        ino = Inode.unpack(fh.ino)
        try:
            self._rpc(ino.host_id, Message(MsgType.TRUNCATE,
                                           {"file_id": ino.file_id, "size": 0}))
        except OSError as e:
            if not (ignore_enoent and e.errno == errno.ENOENT):
                raise
        fh.pending_trunc = False
        fh.inline = None  # DoM: the open() reply carried pre-truncation data

    def read(self, fd: int, n: int = -1) -> bytes:
        fh = self._fds[fd]
        self._flush_trunc(fh)
        length = n if n >= 0 else (1 << 31)
        if fh.inline is not None:  # DoM: served from the open() reply
            data = fh.inline[fh.offset : fh.offset + length]
            fh.offset += len(data)
            return data
        ino = Inode.unpack(fh.ino)
        resp = self._rpc(ino.host_id, Message(MsgType.READ, {
            "file_id": ino.file_id, "offset": fh.offset, "length": length}))
        fh.offset += len(resp.payload)
        return bytes(resp.payload)  # user-facing: materialize the view

    def write(self, fd: int, data: bytes) -> int:
        fh = self._fds[fd]
        ino = Inode.unpack(fh.ino)
        h = {"file_id": ino.file_id, "offset": fh.offset}
        if fh.pending_trunc:
            h["truncate"] = True
            fh.pending_trunc = False
        resp = self._rpc(ino.host_id, Message(MsgType.WRITE, h, data))
        fh.offset += resp.header["written"]
        fh.inline = None
        return resp.header["written"]

    def fsync(self, fd: int) -> None:
        """Synchronous durability barrier.  The Lustre baselines have no
        client-side write buffering — every write() already blocked on its
        RPC — so fsync() is just the server-side FSYNC, kept synchronous
        for contrast with BuffetFS's write-behind pipeline."""
        fh = self._fds[fd]
        self._flush_trunc(fh)
        ino = Inode.unpack(fh.ino)
        self._rpc(ino.host_id, Message(MsgType.FSYNC,
                                       {"file_id": ino.file_id}))

    def close(self, fd: int) -> None:
        with self._lock:
            fh = self._fds.pop(fd, None)
        if fh is None:
            raise err(errno.EBADF, str(fd))
        ino = Inode.unpack(fh.ino)
        # O_TRUNC with no intervening write: the deferred truncate must
        # still happen — flush it before the (async) close wrap-up
        self._flush_trunc(fh, ignore_enoent=True)
        self._close_q.put(Message(MsgType.CLOSE, {
            "host": MDS, "file_id": ino.file_id,
            "client_id": self.client_id, "pid": self.pid, "fd": fd}))

    def _close_worker(self) -> None:
        while True:
            msg = self._close_q.get()
            if msg is None:
                self._close_q.task_done()
                return
            host = msg.header.pop("host")
            try:
                self._rpc(host, msg, critical=False)
            except Exception:
                pass
            finally:
                self._close_q.task_done()

    def drain(self) -> None:
        self._close_q.join()

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        parent_fid, name = self._resolve_parent(path)
        self._rpc(MDS, Message(MsgType.MKDIR, {
            "parent": parent_fid, "name": name, "mode": mode,
            "uid": self.cred.uid, "gid": self.cred.gid,
            "client_id": self.client_id}))

    def shutdown(self) -> None:
        self._close_q.put(None)


class LustreDoMClient(LustreNormalClient):
    """Lustre with Data-on-MDT: open() returns small-file data inline."""

    dom = True


def mkfs_lustre(cluster: BuffetCluster, *, dom: bool) -> None:
    """Baseline layout note: the namespace root already lives on host 0 (the
    MDS).  With DoM, small files are placed on the MDS too (CREATE via MDS
    puts data host = MDS); without DoM, file data should be striped to OSSes
    — our CREATE-on-parent-host places data on the MDS as well, which if
    anything *flatters* Lustre-Normal (no MDS->OSS layout indirection), so
    the BuffetFS comparison stays conservative."""
    # nothing to do: kept for explicitness in benchmarks
    return None

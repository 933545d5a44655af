"""Home-host commit-log replication (the control-plane half of failover).

Every file has exactly one coherence authority — its home host — so a home
crash used to take the file's metadata, leases, and small-file data offline
until a restart.  This module makes the crash survivable without putting
replication on any critical path:

  * `ReplicationLog` (home side): a sequence-numbered in-memory log of
    commit records.  Mutation handlers append records at apply time (NOT
    from `_persist`, which is a no-op under the default fsync policy) and
    return immediately; a background shipper thread drains the log in
    batches to the designated standby (`BuffetCluster.replica_host`) over
    the ordinary transport (`MsgType.REPL_APPEND`).  Acks are cumulative —
    the standby answers with the highest contiguous sequence it applied —
    and unacked records are retained for resend, so the only loss window a
    crash leaves is the bounded shipping lag surfaced in `io_stats()`.

  * `ReplicaStore` (standby side): the replica of one home's state, applied
    record-by-record.  Namespace records (meta/dentry/dir upserts and
    deletes, exactly the `_persist` blob's shapes) are held as dicts; data
    records (whole-file object writes, home-resident chunk writes) are
    applied straight into a staging object store on the standby's disk, so
    promotion never replays payload bytes.  A `snap` record resets the
    replica wholesale — the home sends one when it starts shipping, after a
    restart, or when the standby reports a gap it cannot bridge.

Promotion (`BServer.promote_peer` / `MsgType.PROMOTE`) materializes the
replica into a loadable backing directory and boots a fresh `BServer` with
the dead host's identity and a bumped incarnation; see bserver.py.

Record shapes (all JSON-safe; `plen` marks how many payload bytes ride with
the record inside the REPL_APPEND frame, concatenated in record order):

    {"op": "snap",  "blob": <persist blob>}          reset + full metadata
    {"op": "meta",  "fid": f, "m": <meta dict>}      FileMeta upsert
    {"op": "meta_del", "fid": f}                     FileMeta + object drop
    {"op": "dentry", "dir": d, "name": n, "e": ...}  dentry upsert
    {"op": "dentry_del", "dir": d, "name": n}
    {"op": "dir", "fid": f} / {"op": "dir_del", ...} directory table
    {"op": "next_fid", "v": n}                       allocator high-water
    {"op": "odata", "fid": f, "off": o, "plen": n}   object write (payload)
    {"op": "otrunc", "fid": f, "size": s}            object truncate
    {"op": "cdata", "home": h, "fid": f, "idx": i,
     "off": o, "plen": n}                            chunk write (payload)
    {"op": "ctrunc", "home": h, "fid": f, "ops": L}  chunk clip/delete plan
    {"op": "cdel", "home": h, "fid": f, "indices": L} chunk unlink
    {"op": "groups", "g": {uid: [gid,..]}, "gver": n} group-table replace
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .wire import Message, MsgType

# shipping batch bounds: enough to amortize a round trip, small enough that
# one batch never holds the standby's apply lock for long
MAX_BATCH_RECORDS = 256
MAX_BATCH_BYTES = 4 << 20
# resend backoff while the standby is unreachable (exponential, capped)
SHIP_BACKOFF_S = 0.02
SHIP_BACKOFF_CAP_S = 1.0


class ReplicationLog:
    """Home-side commit log + background shipper.

    `append` is the only hot-path call: one lock, one deque append, one
    notify.  Everything else — batching, sending, resend on NACK, full
    resync when the standby lost its state — happens on the shipper thread.
    """

    def __init__(self, server, target_host: int) -> None:
        self.server = server
        self.target_host = target_host
        self._cond = threading.Condition()
        # unacked records, oldest first: (seq, record dict, payload bytes)
        self._pending: Deque[Tuple[int, Dict, bytes]] = deque()
        self._next_seq = 0          # next sequence number to assign
        self._cursor = 0            # next sequence number to ship
        self._acked = -1            # highest sequence acked by the standby
        self._stop = False
        self.shipped_batches = 0
        self.shipped_records = 0
        self.resyncs = 0            # full state re-ships (standby amnesia)
        self.ship_errors = 0        # send attempts the standby never answered
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"repl-ship-{server.host_id}->{target_host}")
        self._thread.start()

    # --- hot path ------------------------------------------------------
    def append(self, rec: Dict, payload: bytes = b"") -> None:
        if payload:
            rec = dict(rec)
            rec["plen"] = len(payload)
            payload = bytes(payload)  # memoryviews die with their frame
        with self._cond:
            if self._stop:
                return
            self._pending.append((self._next_seq, rec, payload))
            self._next_seq += 1
            self._cond.notify_all()

    # --- introspection -------------------------------------------------
    @property
    def lag(self) -> int:
        """Records appended but not yet acked by the standby."""
        with self._cond:
            return self._next_seq - 1 - self._acked

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "repl_lag": self._next_seq - 1 - self._acked,
                "repl_acked_seq": self._acked,
                "repl_shipped_batches": self.shipped_batches,
                "repl_shipped_records": self.shipped_records,
                "repl_resyncs": self.resyncs,
                "repl_ship_errors": self.ship_errors,
            }

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every appended record is acked (True) or `timeout`
        elapses (False).  Test/benchmark hook — production callers read
        `lag` and let the shipper run."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._acked < self._next_seq - 1:
                left = deadline - time.monotonic()
                if left <= 0 or self._stop:
                    return False
                self._cond.wait(min(left, 0.05))
            return True

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def begin_snapshot(self, blob: Dict) -> None:
        """Reset the log to a fresh full-metadata snapshot record.

        MUST be called under the server's meta lock (`BServer._repl_seed`
        does): every metadata record is journaled inside the same lock hold
        as its mutation, so records dropped here are provably covered by
        `blob`; data records are journaled only after their bytes hit disk,
        so the data walk that follows the snapshot re-reads them.  Dropped
        records are accounted as settled — the snapshot subsumes them."""
        with self._cond:
            snap_seq = self._next_seq
            self._pending.clear()
            self._pending.append((snap_seq, {"op": "snap", "blob": blob},
                                  b""))
            self._next_seq = snap_seq + 1
            self._acked = snap_seq - 1
            self._cursor = snap_seq
            self._cond.notify_all()

    # --- shipper thread ------------------------------------------------
    def _take_batch(self) -> Optional[Tuple[int, List[Dict], bytes]]:
        """Next unshipped batch (seq_base, records, payload) or None when
        caught up; blocks until there is work or stop."""
        with self._cond:
            while not self._stop and self._cursor >= self._next_seq:
                self._cond.wait(0.2)
            if self._stop:
                return None
            recs: List[Dict] = []
            parts: List[bytes] = []
            nbytes = 0
            base = self._cursor
            for seq, rec, payload in self._pending:
                if seq < base:
                    continue
                if recs and (len(recs) >= MAX_BATCH_RECORDS
                             or nbytes + len(payload) > MAX_BATCH_BYTES):
                    break
                recs.append(rec)
                parts.append(payload)
                nbytes += len(payload)
            self._cursor = base + len(recs)
            return base, recs, b"".join(parts)

    def _run(self) -> None:
        backoff = SHIP_BACKOFF_S
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            base, recs, payload = batch
            msg = Message(MsgType.REPL_APPEND,
                          {"home": self.server.host_id,
                           "hver": self.server.version,
                           "seq": base, "recs": recs},
                          payload)
            resp = self.server._repl_send(self.target_host, msg)
            need_seed = False
            with self._cond:
                if self._stop:
                    return
                if resp.type is not MsgType.OK:
                    # standby unreachable / stopped: rewind and retry the
                    # same batch after a capped exponential backoff
                    self.ship_errors += 1
                    self._cursor = min(self._cursor, base)
                    delay = backoff
                    backoff = min(backoff * 2, SHIP_BACKOFF_CAP_S)
                else:
                    delay = 0.0
                    backoff = SHIP_BACKOFF_S
                    acked = resp.header.get("acked", -1)
                    if resp.header.get("resync"):
                        floor = (self._pending[0][0] if self._pending
                                 else self._next_seq)
                        if acked >= floor - 1:
                            # gap the standby can bridge from our retained
                            # tail: rewind the cursor, records are still here
                            self._cursor = acked + 1
                        else:
                            # standby lost state we already trimmed (its
                            # restart): re-seed with a fresh snapshot; the
                            # snap record resets the replica wholesale
                            self.resyncs += 1
                            need_seed = True
                    if acked > self._acked:
                        self._acked = acked
                        while self._pending and self._pending[0][0] <= acked:
                            self._pending.popleft()
                        self.shipped_records = self._acked + 1
                    self.shipped_batches += 1
                    self._cond.notify_all()
            if need_seed:
                self.server._repl_seed()
            if delay:
                time.sleep(delay)


class ReplicaStore:
    """Standby-side replica of one home's state.

    Metadata lives in dicts shaped exactly like the `_persist` blob; data
    records apply straight into `<dir>/objs` using the same object/chunk
    file naming as `BServer`, so `materialize()` only has to write
    `meta.json` to turn the replica into a loadable backing directory.

    The staged state is CRASH-PERSISTENT: every applied batch checkpoints
    the metadata dicts together with `applied`/`hver` to
    `repl_state.json` (tmp + fsync + replace, beside where meta.json will
    land), and a store rebuilt after a standby reboot reloads it — so the
    home's next REPL_APPEND continues incrementally from `applied + 1`
    instead of tripping the resync path and re-shipping a full snapshot.
    (The object/chunk bytes were already on disk under `objs/`; it was
    only this index that used to be memory-only.)
    """

    STATE_FILE = "repl_state.json"

    def __init__(self, home: int, root_dir: str) -> None:
        self.home = home
        self.dir = root_dir
        self.objs = os.path.join(root_dir, "objs")
        os.makedirs(self.objs, exist_ok=True)
        self.lock = threading.Lock()
        self.applied = -1           # highest contiguously applied sequence
        self.hver = 0               # home incarnation at last append
        self.next_file_id = 0
        self.meta: Dict[int, Dict] = {}
        self.dirs: Dict[int, Dict[str, Dict]] = {}
        # group-membership table + version, stored verbatim (JSON string
        # keys); BServer._load_meta normalizes after materialize()
        self.groups: Dict = {}
        self.gver = 0
        self.records_applied = 0
        self._load_state()

    # --- crash persistence ---------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.dir, self.STATE_FILE)

    def _load_state(self) -> None:
        try:
            with open(self._state_path()) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return  # fresh standby (or torn tmp file): start from nothing
        self.applied = blob.get("applied", -1)
        self.hver = blob.get("hver", 0)
        self.next_file_id = blob.get("next_file_id", 0)
        self.meta = {int(f): m for f, m in blob.get("meta", {}).items()}
        self.dirs = {int(f): es for f, es in blob.get("dirs", {}).items()}
        self.groups = dict(blob.get("groups", {}))
        self.gver = blob.get("gver", 0)
        self.records_applied = blob.get("records_applied", 0)

    def _save_state_locked(self) -> None:
        blob = {
            "applied": self.applied,
            "hver": self.hver,
            "next_file_id": self.next_file_id,
            "meta": {str(f): m for f, m in self.meta.items()},
            "dirs": {str(f): es for f, es in self.dirs.items()},
            "groups": dict(self.groups),
            "gver": self.gver,
            "records_applied": self.records_applied,
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    # --- apply ---------------------------------------------------------
    def apply_batch(self, seq: int, recs: List[Dict], payload,
                    hver: int) -> Dict:
        """Apply one REPL_APPEND batch; returns the response header.  A
        batch beyond `applied + 1` is refused with resync=True (the home
        rewinds or re-seeds); a batch at or below it is applied only past
        the already-applied prefix (duplicate re-ships are idempotent)."""
        with self.lock:
            if recs and recs[0].get("op") == "snap":
                # a snapshot-leading batch resets the replica: accept it
                # across any gap IN EITHER DIRECTION — forward is the home
                # bridging a standby that lost its state, backward is a
                # rebooted home whose fresh log restarted at seq 0 (its
                # snap must not be swallowed by the duplicate filter, or
                # every post-reboot mutation gets acked without applying)
                self.applied = seq - 1
            elif seq > self.applied + 1:
                return {"acked": self.applied, "resync": True}
            off = 0
            advanced = False
            for i, rec in enumerate(recs):
                plen = rec.get("plen", 0)
                data = bytes(payload[off:off + plen]) if plen else b""
                off += plen
                if seq + i <= self.applied:
                    continue
                self._apply(rec, data)
                self.applied = seq + i
                self.records_applied += 1
                advanced = True
            self.hver = max(self.hver, hver)
            if advanced:
                # checkpoint BEFORE acking: the home trims its log up to
                # the ack, so an acked-but-unpersisted prefix would be
                # unrecoverable after a standby crash
                self._save_state_locked()
            return {"acked": self.applied}

    def _obj_path(self, fid: int) -> str:
        return os.path.join(self.objs, f"{fid:016x}")

    def _chunk_path(self, home: int, fid: int, idx: int) -> str:
        return os.path.join(self.objs, f"c{home:03x}_{fid:016x}_{idx:08x}")

    @staticmethod
    def _pwrite(path: str, off: int, data: bytes) -> None:
        mode = "r+b" if os.path.exists(path) else "wb"
        with open(path, mode) as f:
            f.seek(off)
            f.write(data)

    @staticmethod
    def _truncate(path: str, size: int) -> None:
        mode = "r+b" if os.path.exists(path) else "wb"
        with open(path, mode) as f:
            f.truncate(size)

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    def _apply(self, rec: Dict, data: bytes) -> None:
        op = rec["op"]
        if op == "snap":
            blob = rec["blob"]
            self.next_file_id = blob["next_file_id"]
            self.meta = {int(f): dict(m) for f, m in blob["meta"].items()}
            self.dirs = {int(f): dict(es) for f, es in blob["dirs"].items()}
            self.groups = dict(blob.get("groups", {}))
            self.gver = blob.get("gver", 0)
            # the snapshot restarts the data stream too: whatever object
            # bytes we held may predate or postdate it, and the home
            # re-ships them right behind the snap
            for name in os.listdir(self.objs):
                self._unlink(os.path.join(self.objs, name))
        elif op == "meta":
            self.meta[rec["fid"]] = rec["m"]
        elif op == "meta_del":
            self.meta.pop(rec["fid"], None)
            self._unlink(self._obj_path(rec["fid"]))
        elif op == "dentry":
            self.dirs.setdefault(rec["dir"], {})[rec["name"]] = rec["e"]
        elif op == "dentry_del":
            self.dirs.get(rec["dir"], {}).pop(rec["name"], None)
        elif op == "dir":
            self.dirs.setdefault(rec["fid"], {})
        elif op == "dir_del":
            self.dirs.pop(rec["fid"], None)
        elif op == "next_fid":
            self.next_file_id = max(self.next_file_id, rec["v"])
        elif op == "groups":
            # full-table replacement, idempotent by construction; gver is
            # monotonic so duplicate re-ships cannot roll grants back
            if rec["gver"] >= self.gver:
                self.groups = dict(rec["g"])
                self.gver = rec["gver"]
        elif op == "odata":
            if rec.get("trunc"):
                self._truncate(self._obj_path(rec["fid"]), 0)
            self._pwrite(self._obj_path(rec["fid"]), rec["off"], data)
        elif op == "otrunc":
            self._truncate(self._obj_path(rec["fid"]), rec["size"])
        elif op == "cdata":
            self._pwrite(
                self._chunk_path(rec["home"], rec["fid"], rec["idx"]),
                rec["off"], data)
        elif op == "ctrunc":
            for idx, new_len in rec["ops"]:
                path = self._chunk_path(rec["home"], rec["fid"], idx)
                if new_len < 0:
                    self._unlink(path)
                elif os.path.exists(path):
                    self._truncate(path, new_len)
        elif op == "cdel":
            for idx in rec["indices"]:
                self._unlink(self._chunk_path(rec["home"], rec["fid"], idx))
        # unknown ops are skipped, not fatal: a newer home may ship record
        # kinds an older standby build does not know — promotion correctness
        # for the kinds it DOES know is unaffected

    # --- promotion -----------------------------------------------------
    def materialize(self) -> str:
        """Write `meta.json` so `self.dir` is a loadable BServer backing
        directory (the object store is already in place); returns it."""
        with self.lock:
            blob = {
                "next_file_id": self.next_file_id,
                "meta": {str(f): m for f, m in self.meta.items()},
                "dirs": {str(f): es for f, es in self.dirs.items()},
                "groups": dict(self.groups),
                "gver": self.gver,
            }
            tmp = os.path.join(self.dir, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, "meta.json"))
            # the staging checkpoint has served its purpose: the promoted
            # server owns this directory now, and a stale repl_state.json
            # must not masquerade as resumable standby state
            try:
                os.unlink(self._state_path())
            except FileNotFoundError:
                pass
        return self.dir

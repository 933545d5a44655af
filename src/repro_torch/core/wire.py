"""BuffetFS wire protocol.

Length-prefixed binary frames.  Since the binary-header fast path (this
module's v2 format) every hot verb encodes and decodes with ZERO JSON on the
critical path: the common control fields (request id, incarnation, file_id,
offset, length, size, epoch, wseq, written, errno, batch count, chunk
index/home, plus the eof/lease/truncate/inline flags) live in a struct-packed
fixed header, and only the *rare* verbs (directory entries, create/rename
names, lease records, batch status vectors) spill into an optional JSON
extension blob appended after the fixed fields:

    v2 (binary header — what encode() emits):
        [ u32 total ][ u8 msg_type|0x80 ][ u32 present ]
        [ packed fields for each set present bit, slot order ]
        [ u32 ext_len ][ ext JSON ][ payload ]

    v1 (JSON header — still decoded for compatibility):
        [ u32 total ][ u8 msg_type ][ u32 header_len ][ header JSON ][ payload ]

``total`` counts the whole frame including itself, in both formats; the high
bit of the type octet selects the format (MsgType values stop far below
0x80).  Headers stay plain dicts in memory — handlers and transports are
format-agnostic — and per-header-shape codecs (cached by key tuple / present
mask) keep the dict<->struct conversion to a couple of C calls per frame.

Framing is zero-copy on the receive side: ``decode`` hands the payload back
as a ``memoryview`` over the input frame (never a slice copy), and
``unpack_batch`` carves sub-messages out of the envelope the same way.  The
ownership rule (docs/ARCHITECTURE.md "Wire format"): a payload view is valid
only until the handler returns / the response is consumed — whoever retains
payload bytes (page cache, user-facing read results) must materialize them
with ``bytes()`` at the retention boundary.

Every request/response is one frame.  A `MsgType.BATCH` envelope packs N
sub-messages (each its own nested frame) into one request frame, so N
operations cost one round trip; the response is a BATCH of sub-responses
with a per-sub-message status vector.  `RpcStats` counts RPCs by type and by
whether they sat on the critical path — RPC *count* is the paper's primary
metric (BuffetFS restrains file access to ONE critical-path RPC; Lustre needs
three round trips of which close() is async) — plus the sub-operations
carried inside batches and the per-verb serialization time (encode_ns /
decode_ns), so protocol cost is visible separately from transfer cost.
"""
from __future__ import annotations

import json
import struct
import threading
from collections import Counter
from dataclasses import dataclass, field
from enum import IntEnum
from operator import itemgetter
from typing import Any, Dict, List, Optional, Tuple, Union

Buf = Union[bytes, bytearray, memoryview]


class MsgType(IntEnum):
    # --- client -> server ---
    LOOKUP_DIR = 1      # fetch directory data: dentries + 10-byte perm records
    LOOKUP_TREE = 20    # bounded-depth subtree of dentries + perms (readdirplus)
    READ = 2            # may carry incomplete_open flag (deferred open step 2)
    WRITE = 3           # may carry incomplete_open flag
    CLOSE = 4           # async: remove from opened-file list
    CREATE = 5
    MKDIR = 6
    UNLINK = 7
    RMDIR = 8
    CHMOD = 9           # triggers invalidation fan-out (§3.4)
    CHOWN = 10
    RENAME = 11
    STAT = 12
    TRUNCATE = 13
    OPEN_RECORD = 14    # explicit open-state record (baselines; BuffetFS defers)
    READ_INLINE = 15    # DoM-style open+read combined (baseline Lustre-DoM)
    PING = 16
    REVALIDATE = 17     # client refreshes an invalidated tree node
    MKNOD_OBJ = 18      # allocate file/dir object on a data host (cross-host)
    LINK_DENTRY = 19    # insert dentry(+10-byte perm) into parent's namespace host
    FSYNC = 21          # durability barrier: flush object data + metadata to disk
    # --- striped data plane (chunk objects on stripe hosts) ---
    # A striped file's layout (stripe_size + ordered host list) is allocated
    # at CREATE and travels in the dentry next to the 10-byte perm record.
    # Chunk objects live in each stripe host's object store keyed by
    # (home_host, file_id, stripe_index); they carry NO metadata and NO
    # leases — the file's home host (where the dentry's inode points) stays
    # the single coherence authority, so all chunk verbs are blind storage.
    CHUNK_READ = 22     # read a byte range of one chunk object
    CHUNK_WRITE = 23    # write a byte range of one chunk object; carries the
                        # chunk epoch it was scattered under — a stripe host
                        # refuses (EPOCHSTALE) epochs older than its latch
    CHUNK_TRUNC = 24    # clip/delete chunk objects (home-host truncate fan-out)
    CHUNK_UNLINK = 25   # remove chunk objects (home-host unlink fan-out)
    CHUNK_FSYNC = 26    # fsync chunk objects (home-host fsync fan-out)
    SCRUB = 27          # run one scrub pass: reconcile this host's chunk
                        # store against home-host layouts (reap dead-file
                        # orphans, clip bytes beyond the committed size)
    SCRUB_CLIP = 28     # server-to-server layout query from a scrubbing
                        # stripe host to a file's home host: "I hold these
                        # chunks at these lengths — dead, or clip to what?"
    # --- replication / failover (home-host standby) ---
    REPL_APPEND = 29    # home -> standby: a seq-numbered batch of commit-log
                        # records (metadata mutations + home-resident object
                        # writes); the standby applies them in order and acks
                        # the highest contiguous sequence it holds.  Shipped
                        # asynchronously off the critical path; the ack
                        # drives the home's bounded-lag accounting.
    PROMOTE = 30        # ask a standby to promote its replica of a dead
                        # home: replay the received log into a fresh serving
                        # instance, bump the incarnation, return the new
                        # (addr, version) so the cluster config can re-point
    # --- rich permissions (ACL + group grants) ---
    SETACL = 31         # replace one dentry's ACL (list of [kind, id,
                        # allow, deny] entries riding the ext blob, like the
                        # lease record).  Same §3.4 two-phase as CHMOD: every
                        # watcher is invalidated BEFORE the new ACL applies,
                        # so no client can serve a withdrawn grant after the
                        # mutation acks.
    # --- server -> client (callback channel) ---
    INVALIDATE = 32     # server asks client to invalidate cached tree nodes
    REVOKE_LEASE = 33   # server recalls a read lease before applying a data
                        # mutation (write/truncate/unlink) — the data-plane
                        # twin of INVALIDATE.  A READ carrying a "lease"
                        # record in its header is granted one ("lease": true
                        # in the response); the grant entitles the client to
                        # serve that file's blocks from its local page cache
                        # with zero RPCs until revoked.  An INVALIDATE with
                        # a truthy "groups" header targets the client's
                        # cached group-membership table instead of a tree
                        # node (same blocking mark-before-ack discipline).
    SETGROUPS = 34      # replace one uid's extra group memberships in the
                        # cluster-wide group table (authority: host 0, the
                        # root's home).  Every client that fetched the table
                        # is invalidated (blocking) BEFORE the change
                        # applies — a withdrawn membership can never
                        # authorize after the ack.
    LOOKUP_GROUPS = 35  # fetch the group table (+ its version `gver`) and
                        # register for its invalidation callbacks — the
                        # group-table twin of LOOKUP_DIR.
    # --- failure detection / chunk replication ---
    HEARTBEAT = 36      # server-to-server liveness probe.  Cheaper than PING
                        # in one crucial way: the receiver answers REGARDLESS
                        # of the sender's `ver` stamp (no ESTALE), because a
                        # prober that has not yet learned a promoted
                        # incarnation must still be able to observe the host
                        # as alive.  Each server probes its peers on a
                        # background thread; the cluster's auto-promote
                        # monitor reads the resulting per-peer last-seen
                        # table and triggers promote() only with a QUORUM of
                        # observers agreeing a host is gone.
    CHUNK_STAT = 37     # blind storage probe: "what length do you hold for
                        # chunk (home, file_id, index)?" — the scrubber's
                        # repair scan uses it to find replicas missing their
                        # copy without moving data.
    # --- generic ---
    OK = 64
    ERROR = 65
    BATCH = 66          # envelope packing N sub-messages into one frame


# Out-of-band errno for chunk-epoch staleness: a scatter (CHUNK_WRITE) or
# commit (WRITE with "commit") carrying an epoch older than the file's
# current chunk epoch is refused with this code and the current epoch in
# the error header, so the writer can re-scatter at the new epoch instead
# of silently publishing bytes a concurrent truncate already clipped.
# Deliberately outside the OS errno range: no kernel errno may alias it.
EPOCHSTALE = 1064

# ---------------------------------------------------------------------------
# v2 binary header codec
# ---------------------------------------------------------------------------

# The fixed-field slot table.  Position in this tuple IS the bit index in the
# u32 `present` mask and the canonical packing order; appending new slots is
# wire-compatible, reordering or retyping existing ones is NOT (golden-frame
# tests in tests/test_wire_format.py pin the layout).
_SLOT_DEFS: Tuple[Tuple[str, str], ...] = (
    ("_rid", "Q"),      # 0: transport request id (pipelining demux)
    ("ver", "I"),       # 1: server incarnation the sender believes in
    ("file_id", "Q"),   # 2
    ("offset", "Q"),    # 3
    ("length", "Q"),    # 4
    ("size", "Q"),      # 5
    ("epoch", "Q"),     # 6: chunk epoch (truncate-vs-scatter ordering)
    ("wseq", "Q"),      # 7: per-file write sequence (cache coherence stamp)
    ("written", "Q"),   # 8
    ("errno", "I"),     # 9: includes the out-of-band EPOCHSTALE=1064
    ("n", "I"),         # 10: BATCH sub-message count
    ("index", "I"),     # 11: chunk/stripe index
    ("home", "I"),      # 12: home host of a chunk object's file
    ("eof", "B"),       # 13: bool
    ("lease", "B"),     # 14: bool grant form only; the request-side lease
                        #     RECORD (a dict) rides the extension blob
    ("truncate", "B"),  # 15: bool
    ("inline", "B"),    # 16: bool (Lustre-DoM inline data marker)
    ("lease_ttl_ms", "I"),  # 17: TTL of a granted read lease, milliseconds.
                        #     Appended after the v2 freeze (append-only is
                        #     wire-compatible): a grant response carries it
                        #     next to the `lease` flag, the client stops
                        #     serving cached blocks once it elapses, and the
                        #     server may wait it out instead of force-
                        #     breaking an unacked revoke.
    ("gver", "I"),      # 18: group-table version.  The authority host
                        #     stamps it on LOOKUP_DIR/LOOKUP_TREE/
                        #     LOOKUP_GROUPS responses; a client holding an
                        #     older table drops it and refetches lazily —
                        #     the belt-and-braces path for grants revoked
                        #     while the client was not yet registered for
                        #     the blocking callback (e.g. across a
                        #     failover to a promoted standby).
)
_SLOT_INDEX = {name: i for i, (name, _) in enumerate(_SLOT_DEFS)}
_BOOL_SLOTS = frozenset(n for n, f in _SLOT_DEFS if f == "B")
_U32_MAX = 0xFFFFFFFF
_U64_MAX = 0xFFFFFFFFFFFFFFFF

_BIN = 0x80                       # high bit of the type octet => v2 header
_PREFIX = struct.Struct("<IB")    # total, type octet (both formats)
_U32 = struct.Struct("<I")
_JHDR = struct.Struct("<IBI")     # v1: total, msg_type, header_len

_dumps = json.dumps
_loads = json.loads
_MT_MAP = MsgType._value2member_map_


class _Enc:
    """Per-header-shape encoder, cached by the header's key tuple: one
    struct.pack call emits prefix + present mask + fixed fields + ext_len."""

    __slots__ = ("pack", "present", "getter", "nslots", "base", "ext_keys")

    def __init__(self, keys: Tuple[str, ...]) -> None:
        slots = sorted(_SLOT_INDEX[k] for k in keys if k in _SLOT_INDEX)
        ext = tuple(k for k in keys if k not in _SLOT_INDEX)
        present = 0
        fmt = "<IBI"
        for i in slots:
            present |= 1 << i
            fmt += _SLOT_DEFS[i][1]
        fmt += "I"  # ext_len
        st = struct.Struct(fmt)
        self.pack = st.pack
        self.present = present
        self.base = st.size
        self.nslots = len(slots)
        names = tuple(_SLOT_DEFS[i][0] for i in slots)
        self.getter = itemgetter(*names) if names else None
        self.ext_keys = ext or None


class _Dec:
    """Per-present-mask decoder: one struct.unpack_from recovers the fixed
    fields + ext_len; dict(zip(...)) rebuilds the header dict."""

    __slots__ = ("unpack_from", "names", "bools", "size")

    def __init__(self, present: int) -> None:
        names: List[str] = []
        fmt = "<"
        for i, (name, f) in enumerate(_SLOT_DEFS):
            if present >> i & 1:
                if not name:
                    raise ValueError(f"unknown present bit {i}")
                names.append(name)
                fmt += f
        if present >> len(_SLOT_DEFS):
            raise ValueError(f"unknown present bits in {present:#x}")
        fmt += "I"  # trailing ext_len
        st = struct.Struct(fmt)
        self.unpack_from = st.unpack_from
        # zip() below stops at names, silently dropping the ext_len value
        self.names = tuple(names)
        self.bools = tuple(n for n in names if n in _BOOL_SLOTS)
        self.size = st.size


_ENC_CACHE: Dict[Tuple[str, ...], _Enc] = {}
_DEC_CACHE: Dict[int, _Dec] = {}


def _encoder(header: Dict[str, Any]) -> _Enc:
    keys = tuple(header)
    enc = _ENC_CACHE.get(keys)
    if enc is None:
        if len(_ENC_CACHE) > 4096:  # runaway-shape backstop; shapes are few
            _ENC_CACHE.clear()
        enc = _ENC_CACHE[keys] = _Enc(keys)
    return enc


def _encode_header_slow(msg_type: int, header: Dict[str, Any],
                        payload_len: int) -> bytes:
    """Value-driven fallback: a slot-named key whose value does not fit its
    fixed field (a lease RECORD dict, a negative or oversized int) spills to
    the extension blob instead of failing the frame."""
    present = 0
    fmt = "<IBI"
    vals: List[int] = []
    ext: Optional[Dict[str, Any]] = None
    for i, (name, f) in enumerate(_SLOT_DEFS):
        if name not in header:
            continue
        v = header[name]
        if f == "B":
            if isinstance(v, bool):
                present |= 1 << i
                fmt += f
                vals.append(int(v))
                continue
        elif (isinstance(v, int) and not isinstance(v, bool)
                and 0 <= v <= (_U64_MAX if f == "Q" else _U32_MAX)):
            present |= 1 << i
            fmt += f
            vals.append(v)
            continue
        ext = ext if ext is not None else {}
        ext[name] = v
    for k, v in header.items():
        if k not in _SLOT_INDEX:
            ext = ext if ext is not None else {}
            ext[k] = v
    ej = _dumps(ext, separators=(",", ":")).encode() if ext else b""
    fmt += "I"
    st = struct.Struct(fmt)
    total = st.size + len(ej) + payload_len
    return st.pack(total, msg_type | _BIN, present, *vals, len(ej)) + ej


def encode_header(msg_type: int, header: Dict[str, Any],
                  payload_len: int) -> bytes:
    """Everything before the payload, as one bytes object (v2 format)."""
    enc = _encoder(header)
    try:
        if enc.ext_keys is None:
            total = enc.base + payload_len
            if enc.nslots > 1:
                return enc.pack(total, msg_type | _BIN, enc.present,
                                *enc.getter(header), 0)
            if enc.nslots == 1:
                return enc.pack(total, msg_type | _BIN, enc.present,
                                enc.getter(header), 0)
            return enc.pack(total, msg_type | _BIN, enc.present, 0)
        ej = _dumps({k: header[k] for k in enc.ext_keys},
                    separators=(",", ":")).encode()
        total = enc.base + len(ej) + payload_len
        if enc.nslots > 1:
            return enc.pack(total, msg_type | _BIN, enc.present,
                            *enc.getter(header), len(ej)) + ej
        if enc.nslots == 1:
            return enc.pack(total, msg_type | _BIN, enc.present,
                            enc.getter(header), len(ej)) + ej
        return enc.pack(total, msg_type | _BIN, enc.present, len(ej)) + ej
    except (struct.error, TypeError, OverflowError):
        return _encode_header_slow(msg_type, header, payload_len)


def encode(msg_type: int, header: Dict[str, Any], payload: Buf = b"") -> bytes:
    """One contiguous v2 frame (header + payload copy).  The scatter/gather
    send paths use ``encode_header`` / ``Message.encode_parts`` instead, so
    bulk payloads never get concatenated into a fresh buffer."""
    hdr = encode_header(msg_type, header, len(payload))
    if not payload:
        return hdr
    return hdr + payload if type(payload) is bytes else b"".join((hdr, payload))


def encode_json(msg_type: int, header: Dict[str, Any], payload: Buf = b""
                ) -> bytes:
    """The v1 (JSON-header) encoder, kept for compatibility tests and as the
    wire microbench baseline; ``decode`` accepts both formats."""
    hj = _dumps(header, separators=(",", ":")).encode()
    total = _JHDR.size + len(hj) + len(payload)
    return _JHDR.pack(total, msg_type, len(hj)) + hj + payload


def decode(frame: Buf):
    """Decode a v1 or v2 frame.  Zero-copy: the returned payload is a
    memoryview over ``frame`` (b"" when empty) — materialize with bytes()
    before retaining it past the frame's lifetime."""
    total, wt = _PREFIX.unpack_from(frame, 0)
    if wt & _BIN:
        (present,) = _U32.unpack_from(frame, 5)
        dec = _DEC_CACHE.get(present)
        if dec is None:
            dec = _DEC_CACHE[present] = _Dec(present)
        vals = dec.unpack_from(frame, 9)
        header = dict(zip(dec.names, vals))
        for k in dec.bools:
            header[k] = header[k] != 0
        off = 9 + dec.size
        elen = vals[-1]
        if elen:
            header.update(_loads(bytes(frame[off:off + elen])))
            off += elen
        t = wt & 0x7F
    else:
        (hlen,) = _U32.unpack_from(frame, 5)
        off = 9 + hlen
        header = _loads(bytes(frame[9:off]))
        t = wt
    if off < total:
        payload: Buf = (frame[off:total] if type(frame) is memoryview
                        else memoryview(frame)[off:total])
    else:
        payload = b""
    mt = _MT_MAP.get(t)
    return (mt if mt is not None else MsgType(t)), header, payload


@dataclass
class Message:
    type: MsgType
    header: Dict[str, Any] = field(default_factory=dict)
    payload: Buf = b""
    # cached frame size (set by encode()/encode_parts()/decode(), reused by
    # nbytes): the honest RpcStats byte figure is the frame as it actually
    # crossed the wire — transport-level framing fields like _rid popped
    # AFTER receive don't un-count their bytes.
    _nbytes: Optional[int] = field(default=None, repr=False, compare=False)
    # cached contiguous frame (set by encode()): pack_batch reuses it so
    # BATCH envelope assembly never re-encodes an already-framed sub-message
    _frame: Optional[bytes] = field(default=None, repr=False, compare=False)
    # serialization durations stamped where the frame actually crosses the
    # wire (TCP transport), harvested into RpcStats by whichever thread
    # completes the request
    _encode_ns: int = field(default=0, repr=False, compare=False)
    _decode_ns: int = field(default=0, repr=False, compare=False)

    def encode(self) -> bytes:
        frame = encode(self.type, self.header, self.payload)
        self._nbytes = len(frame)
        self._frame = frame
        return frame

    def encode_parts(self) -> List[Buf]:
        """Scatter/gather form: [header bytes, payload view] with the
        payload never copied — feed straight to ``socket.sendmsg``."""
        hdr = encode_header(self.type, self.header, len(self.payload))
        self._nbytes = len(hdr) + len(self.payload)
        if self.payload:
            return [hdr, self.payload]
        return [hdr]

    @staticmethod
    def decode(frame: Buf) -> "Message":
        t, h, p = decode(frame)
        m = Message(t, h, p)
        m._nbytes = len(frame)
        return m

    @property
    def nbytes(self) -> int:
        # sized exactly as encode() would frame it, without copying the
        # payload; computed at most once per message
        if self._nbytes is None:
            self._nbytes = (len(encode_header(self.type, self.header, 0))
                            + len(self.payload))
        return self._nbytes


# ---------------------------------------------------------------------------
# Stripe layout record: {"ss": stripe_size, "hosts": [home, h1, ...]} plus an
# optional replication factor {"r": k}.  Allocated at CREATE, stored in the
# dentry next to the 10-byte perm record and in the home host's FileMeta;
# chunk `index` covers file bytes [index*ss, (index+1)*ss) and its j-th
# replica (j in 0..r-1) lives on hosts[(index + j) % len(hosts)] — replica 0
# is the PRIMARY, the only copy a layout without "r" (r=1, every file written
# before chunk replication) ever had, so old layouts decode and place identically.
# ---------------------------------------------------------------------------

def stripe_spans(layout: Dict[str, Any], offset: int, end: int):
    """Split the byte span [offset, end) at stripe boundaries: yields
    (chunk_index, primary_host_id, offset_within_chunk, length) tuples in
    file order — the unit both the scatter (write) and gather (read) paths
    fan out by.  The host yielded is the chunk's PRIMARY replica; callers
    that care about the full replica set use chunk_hosts()."""
    ss = layout["ss"]
    hosts = layout["hosts"]
    idx = offset // ss
    while idx * ss < end:
        lo = max(offset, idx * ss)
        hi = min(end, (idx + 1) * ss)
        yield idx, hosts[idx % len(hosts)], lo - idx * ss, hi - lo
        idx += 1


def chunk_hosts(layout: Dict[str, Any], index: int) -> List[int]:
    """The ordered replica set of chunk `index`: primary first, then the
    next r-1 hosts clockwise on the layout's host ring.  r is clamped to
    the ring size (replicating a chunk onto the same host twice protects
    nothing)."""
    hosts = layout["hosts"]
    n = len(hosts)
    r = min(layout.get("r", 1), n)
    return [hosts[(index + j) % n] for j in range(r)]


def ok(header: Optional[Dict[str, Any]] = None, payload: Buf = b"") -> Message:
    return Message(MsgType.OK, header or {}, payload)


def error(errno_: int, msg: str) -> Message:
    return Message(MsgType.ERROR, {"errno": errno_, "msg": msg})


# ---------------------------------------------------------------------------
# BATCH envelope: N sub-messages in one frame (one round trip on the wire)
# ---------------------------------------------------------------------------

def pack_batch(msgs: List[Message], header: Optional[Dict[str, Any]] = None
               ) -> Message:
    """Pack sub-messages into one BATCH frame.  The payload is the
    concatenation of the sub-messages' own length-prefixed frames, so the
    envelope nests the wire format rather than inventing a second one.
    Already-encoded sub-messages contribute their cached frames; the join
    is a single pre-sized allocation either way, and the envelope's nbytes
    falls out of the payload length without re-encoding anything."""
    env_header: Dict[str, Any] = dict(header or {})
    env_header["n"] = len(msgs)
    return Message(MsgType.BATCH, env_header,
                   b"".join([m._frame if m._frame is not None else m.encode()
                             for m in msgs]))


def unpack_batch(msg: Message) -> List[Message]:
    """Unpack a BATCH envelope back into its sub-messages.  Zero-copy: each
    sub-message is decoded from a memoryview window over the envelope
    payload, so its own payload is a view into the envelope's buffer —
    materialize (bytes()) anything retained past the envelope's lifetime."""
    if msg.type is not MsgType.BATCH:
        raise ValueError(f"not a BATCH message: {msg.type.name}")
    subs: List[Message] = []
    buf = msg.payload
    if type(buf) is not memoryview:
        buf = memoryview(buf)
    off = 0
    for _ in range(msg.header.get("n", 0)):
        (total,) = _U32.unpack_from(buf, off)
        subs.append(Message.decode(buf[off:off + total]))
        off += total
    return subs


def batch_status(responses: List[Message]) -> List[int]:
    """Per-sub-message status vector: 0 for OK, errno otherwise."""
    return [0 if r.type is not MsgType.ERROR else int(r.header.get("errno", 5))
            for r in responses]


class RpcStats:
    """Thread-safe RPC accounting: the reproduction's primary metric."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.by_type: Counter = Counter()
        self.by_host: Counter = Counter()  # server addr -> RPCs sent there:
        # the scatter-gather fan-out metric (how many hosts a striped read
        # actually touched) falls straight out of this counter
        self.critical_path: int = 0      # RPCs the caller blocked on
        self.async_offpath: int = 0      # RPCs issued asynchronously (close())
        self.bytes_sent: int = 0
        self.bytes_recv: int = 0
        self.subops: int = 0             # operations carried (batch sub-msgs)
        # per-verb serialization time (ns), recorded where frames are
        # actually encoded/decoded (the TCP transport; the in-proc transport
        # passes Message objects and records zero) — protocol cost, distinct
        # from transfer cost
        self.encode_ns: Counter = Counter()
        self.decode_ns: Counter = Counter()

    def record(self, msg_type: MsgType, sent: int, recv: int, critical: bool,
               subops: int = 1, addr: str = "", encode_ns: int = 0,
               decode_ns: int = 0) -> None:
        with self._lock:
            self.by_type[msg_type.name] += 1
            if addr:
                self.by_host[addr] += 1
            if critical:
                self.critical_path += 1
            else:
                self.async_offpath += 1
            self.bytes_sent += sent
            self.bytes_recv += recv
            self.subops += subops
            if encode_ns:
                self.encode_ns[msg_type.name] += encode_ns
            if decode_ns:
                self.decode_ns[msg_type.name] += decode_ns

    @property
    def total(self) -> int:
        return sum(self.by_type.values())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "by_type": dict(self.by_type),
                "by_host": dict(self.by_host),
                "total": self.total,
                "critical_path": self.critical_path,
                "async_offpath": self.async_offpath,
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "subops": self.subops,
                "encode_ns": dict(self.encode_ns),
                "decode_ns": dict(self.decode_ns),
            }

    def reset(self) -> None:
        with self._lock:
            self.by_type.clear()
            self.by_host.clear()
            self.critical_path = 0
            self.async_offpath = 0
            self.bytes_sent = 0
            self.bytes_recv = 0
            self.subops = 0
            self.encode_ns.clear()
            self.decode_ns.clear()

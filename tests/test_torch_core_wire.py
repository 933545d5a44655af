"""The port's BuffetFS wire protocol and permission checks against the JAX
package's, on the CPU.

`repro_torch.core` is a copy of `repro.core`'s semantics: the same message
types, the same header bytes (the binary v2 codec and its JSON fallback),
the same BATCH envelope, the same 10-byte permission record and the same
access decision, the same RPC accounting and inode numbers.  Each package
decodes the other's frames.  The server registries are two objects, each
holding its own package's handlers only: a BServer of one package never
answers with the other's code, though every test here imports both.
"""
import errno
import importlib

import numpy as np
import pytest

from repro.core import perms as jax_perms
from repro.core import wire as jax_wire
from repro.core.inode import Inode as JaxInode
from repro_torch.core import perms, wire
from repro_torch.core.inode import ROOT_FILE_ID, Inode

# hot-verb headers: requests and responses of the read and write paths
HEADERS = {
    "read_req": (wire.MsgType.READ, {"file_id": 7, "offset": 4096, "length": 64,
                                     "ver": 2, "_rid": 11}, b""),
    "read_req_lease": (wire.MsgType.READ, {"file_id": 7, "offset": 0, "length": 8192,
                                           "ver": 1, "lease": {"cb": "agent:3", "uid": 1000}},
                       b""),
    "write_req": (wire.MsgType.WRITE, {"file_id": 9, "offset": 128, "ver": 1,
                                       "truncate": True, "commit": [1, 2]}, b"payload!"),
    "chunk_write": (wire.MsgType.CHUNK_WRITE, {"home": 1, "file_id": 7, "index": 2,
                                               "offset": 128, "epoch": 4, "ver": 1},
                    b"chunk"),
    "ok_lease": (wire.MsgType.OK, {"eof": True, "size": 8192, "lease": True,
                                   "lease_ttl_ms": 5000, "wseq": 5, "epoch": 3},
                 b"DATA" * 16),
    "epochstale": (wire.MsgType.ERROR, {"errno": wire.EPOCHSTALE, "epoch": 9,
                                        "msg": "stale epoch"}, b""),
    "max_u64": (wire.MsgType.OK, {"epoch": 2**64 - 1, "wseq": 2**64 - 1,
                                  "offset": 2**64 - 1}, b""),
    "empty": (wire.MsgType.PING, {}, b""),
}


def _jax_type(t):
    return jax_wire.MsgType(int(t))


def test_msgtype_names_and_values_are_equal():
    assert [(m.name, m.value) for m in wire.MsgType] == \
        [(m.name, m.value) for m in jax_wire.MsgType]
    assert wire.EPOCHSTALE == jax_wire.EPOCHSTALE == 1064
    assert wire._SLOT_DEFS == jax_wire._SLOT_DEFS


@pytest.mark.parametrize("codec", ["encode", "encode_json"])
@pytest.mark.parametrize("name", sorted(HEADERS))
def test_frames_are_equal_bytes_and_decode_across(name, codec):
    t, h, p = HEADERS[name]
    port = getattr(wire, codec)(t, dict(h), p)
    jax = getattr(jax_wire, codec)(_jax_type(t), dict(h), p)
    assert port == jax
    for dec, frame, mtype in ((wire.decode, jax, wire.MsgType),
                              (jax_wire.decode, port, jax_wire.MsgType)):
        t2, h2, p2 = dec(frame)
        assert type(t2) is mtype and int(t2) == int(t)
        assert h2 == h and bytes(p2) == p
    # Message.encode and nbytes agree with the function
    m = wire.Message(t, dict(h), p)
    if codec == "encode":
        assert m.nbytes == len(port) and m.encode() == port
        assert b"".join(bytes(x) for x in m.encode_parts()) == port


def test_batch_envelopes_are_equal_and_unpack_across():
    names = ["read_req", "write_req", "chunk_write", "ok_lease"]
    port = wire.pack_batch([wire.Message(HEADERS[n][0], dict(HEADERS[n][1]), HEADERS[n][2])
                            for n in names], {"ver": 3})
    jax = jax_wire.pack_batch([jax_wire.Message(_jax_type(HEADERS[n][0]),
                                                dict(HEADERS[n][1]), HEADERS[n][2])
                               for n in names], {"ver": 3})
    assert port.encode() == jax.encode()
    for unpack, env in ((wire.unpack_batch, wire.Message.decode(jax.encode())),
                        (jax_wire.unpack_batch, jax_wire.Message.decode(port.encode()))):
        subs = unpack(env)
        assert [(int(s.type), s.header, bytes(s.payload)) for s in subs] == \
            [(int(HEADERS[n][0]), HEADERS[n][1], HEADERS[n][2]) for n in names]
    resps = [wire.ok(), wire.error(errno.EACCES, "no"), wire.error(wire.EPOCHSTALE, "s")]
    assert wire.batch_status(resps) == jax_wire.batch_status(
        [jax_wire.ok(), jax_wire.error(errno.EACCES, "no"),
         jax_wire.error(jax_wire.EPOCHSTALE, "s")]) == [0, errno.EACCES, wire.EPOCHSTALE]


def test_stripe_layout_spans_and_hosts_agree():
    rng = np.random.default_rng(3)
    for _ in range(200):
        k = int(rng.integers(1, 5))
        layout = {"ss": int(rng.choice([64, 4096, 65536])),
                  "hosts": [int(h) for h in rng.permutation(6)[:k]]}
        if rng.random() < 0.5:
            layout["r"] = int(rng.integers(1, 4))
        off = int(rng.integers(0, 300_000))
        end = off + int(rng.integers(0, 300_000))
        assert list(wire.stripe_spans(layout, off, end)) == \
            list(jax_wire.stripe_spans(layout, off, end))
        idx = int(rng.integers(0, 50))
        assert wire.chunk_hosts(layout, idx) == jax_wire.chunk_hosts(layout, idx)


def test_perm_records_pack_to_equal_bytes():
    rng = np.random.default_rng(0)
    for _ in range(500):
        mode = int(rng.choice([perms.S_IFDIR, perms.S_IFREG])) | int(rng.integers(0, 0o10000))
        uid, gid = (int(x) for x in rng.integers(0, 2**32, size=2))
        a = perms.PermRecord(mode, uid, gid)
        b = jax_perms.PermRecord(mode, uid, gid)
        assert a.pack() == b.pack() and len(a.pack()) == perms.PERM_BYTES == 10
        assert perms.PermRecord.unpack(b.pack()) == a
        assert jax_perms.PermRecord.unpack(a.pack()) == b
        assert a.with_mode_bits(0o640).pack() == b.with_mode_bits(0o640).pack()


def _acl(rng):
    if rng.random() < 0.4:
        return None
    return [[str(rng.choice(["u", "g"])), int(rng.integers(0, 4)),
             int(rng.integers(0, 8)), int(rng.integers(0, 8))]
            for _ in range(int(rng.integers(1, 4)))]


def test_access_ok_agrees_over_a_seeded_grid():
    """Modes, owners, callers (root among them), supplementary groups, ACLs
    and granted groups drawn from one seed; every wanted mask."""
    rng = np.random.default_rng(7)
    n_true = 0
    for _ in range(3000):
        kind = perms.S_IFDIR if rng.random() < 0.5 else perms.S_IFREG
        mode = kind | int(rng.integers(0, 0o1000))
        owner, group = (int(x) for x in rng.integers(0, 4, size=2))
        uid, gid = (int(x) for x in rng.integers(0, 4, size=2))
        sup = tuple(int(x) for x in rng.integers(0, 6, size=int(rng.integers(0, 3))))
        acl = _acl(rng)
        granted = [int(x) for x in rng.integers(0, 6, size=int(rng.integers(0, 2)))]
        want = int(rng.integers(1, 8))
        got = perms.access_ok(perms.PermRecord(mode, owner, group),
                              perms.Credentials(uid, gid, sup), want, acl, granted)
        ref = jax_perms.access_ok(jax_perms.PermRecord(mode, owner, group),
                                  jax_perms.Credentials(uid, gid, sup), want, acl, granted)
        assert got == ref, (mode, owner, group, uid, gid, sup, acl, granted, want)
        n_true += got
    assert 300 < n_true < 2700          # the grid reaches both answers


@pytest.mark.parametrize("flags", [perms.O_RDONLY, perms.O_WRONLY, perms.O_RDWR,
                                   perms.O_RDONLY | perms.O_TRUNC,
                                   perms.O_WRONLY | perms.O_CREAT | perms.O_TRUNC,
                                   perms.O_RDWR | perms.O_APPEND])
def test_open_flags_and_errors_agree(flags):
    assert perms.flags_to_access(flags) == jax_perms.flags_to_access(flags)
    for name in ("O_RDONLY", "O_WRONLY", "O_RDWR", "O_CREAT", "O_TRUNC", "O_APPEND",
                 "R_OK", "W_OK", "X_OK", "S_IFDIR", "S_IFREG"):
        assert getattr(perms, name) == getattr(jax_perms, name)
    e = perms.err(errno.EACCES, "denied")
    assert isinstance(e, OSError) and isinstance(e, perms.FSError)
    assert e.errno == jax_perms.err(errno.EACCES, "denied").errno == errno.EACCES


def test_acls_and_group_tables_validate_alike():
    for acl in ([["u", 1, 4, 0]], [["g", 2, 7, 2], ["u", 0, 1, 0]], None, []):
        assert perms.validate_acl(acl) == jax_perms.validate_acl(acl)
    for bad in ([["x", 1, 4, 0]], [["u", 1, 9, 0]], [["u", 1]]):
        with pytest.raises(OSError) as a:
            perms.validate_acl(bad)
        with pytest.raises(OSError) as b:
            jax_perms.validate_acl(bad)
        assert a.value.errno == b.value.errno
    table = {"3": [1, 2, 2], 4: []}
    assert perms.normalize_groups(table) == jax_perms.normalize_groups(table)


def test_rpc_stats_record_and_snapshot_alike():
    rng = np.random.default_rng(1)
    a, b = wire.RpcStats(), jax_wire.RpcStats()
    names = [m.name for m in wire.MsgType]
    for _ in range(400):
        t = str(rng.choice(names))
        sent, recv = (int(x) for x in rng.integers(0, 10_000, size=2))
        crit = bool(rng.random() < 0.7)
        kw = {"subops": int(rng.integers(1, 5)), "addr": f"bserver:{rng.integers(0, 4)}",
              "encode_ns": int(rng.integers(0, 3)), "decode_ns": int(rng.integers(0, 3))}
        a.record(wire.MsgType[t], sent, recv, crit, **kw)
        b.record(jax_wire.MsgType[t], sent, recv, crit, **kw)
    assert a.snapshot() == b.snapshot() and a.total == b.total == 400
    a.reset()
    b.reset()
    assert a.snapshot() == b.snapshot() and a.total == 0


def test_inode_numbers_pack_alike():
    rng = np.random.default_rng(2)
    for _ in range(300):
        h, v, f = int(rng.integers(0, 4096)), int(rng.integers(0, 10_000)), \
            int(rng.integers(0, 2**40))
        ino = Inode(h, v, f).pack()
        assert ino == JaxInode(h, v, f).pack()
        assert tuple(Inode.unpack(ino)) == tuple(JaxInode.unpack(ino))
    assert ROOT_FILE_ID == 1


def test_registries_are_apart_and_hold_their_own_handlers():
    """Each package's SERVER_OPS holds the same verbs with the same flags,
    and every handler of the port's is the port's code."""
    port = importlib.import_module("repro_torch.core")
    jax = importlib.import_module("repro.core")
    for mod in ("bserver", "baselines"):
        importlib.import_module(f"repro_torch.core.{mod}")
        importlib.import_module(f"repro.core.{mod}")
    assert port.SERVER_OPS is not jax.SERVER_OPS
    pt, jt = list(port.SERVER_OPS.types()), list(jax.SERVER_OPS.types())
    assert [t.name for t in pt] == [t.name for t in jt] and len(pt) >= 35
    for t in pt:
        po, jo = port.SERVER_OPS.operation(t), jax.SERVER_OPS.operation(jax.MsgType[t.name])
        assert (po.mutating, po.barrier, po.grants_lease, po.breaks_lease) == \
            (jo.mutating, jo.barrier, jo.grants_lease, jo.breaks_lease)
        assert po.handler.__module__.startswith("repro_torch.core."), (t, po.handler)
        assert jo.handler.__module__.startswith("repro.core."), (t, jo.handler)
        assert po.handler.__qualname__ == jo.handler.__qualname__
    assert sorted(port.__all__) == sorted(jax.__all__)

"""Permission records — the paper's "ten extra bytes" per directory entry.

BuffetFS §3.2: "BuffetFS uses ten extra bytes for each directory entry to
store the permission information."  We use exactly ten bytes:

    mode  : u16   (POSIX mode bits, incl. S_IFDIR flag)
    uid   : u32
    gid   : u32

With these ten bytes attached to every child entry of a directory, a client
holding the directory can run the full open()-time permission check for any
child locally — the core mechanism of the paper.
"""
from __future__ import annotations

import errno
import struct
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

# mode bit layout (subset of POSIX st_mode)
S_IFDIR = 0o040000
S_IFREG = 0o100000

R_OK = 4
W_OK = 2
X_OK = 1

# open() flags (mirrors os.O_*)
O_RDONLY = 0o0
O_WRONLY = 0o1
O_RDWR = 0o2
O_CREAT = 0o100
O_TRUNC = 0o1000
O_APPEND = 0o2000
_ACCMODE = 0o3

_FMT = struct.Struct("<HII")  # 2 + 4 + 4 = 10 bytes
PERM_BYTES = _FMT.size
assert PERM_BYTES == 10, "paper specifies ten extra bytes per entry"


@dataclass(frozen=True)
class PermRecord:
    """The 10-byte permission record stored in each parent-directory entry."""

    mode: int
    uid: int
    gid: int

    def pack(self) -> bytes:
        return _FMT.pack(self.mode & 0xFFFF, self.uid, self.gid)

    @staticmethod
    def unpack(b: bytes) -> "PermRecord":
        mode, uid, gid = _FMT.unpack(b)
        return PermRecord(mode, uid, gid)

    @property
    def is_dir(self) -> bool:
        return bool(self.mode & S_IFDIR)

    def with_mode_bits(self, perm_bits: int) -> "PermRecord":
        return PermRecord((self.mode & ~0o777) | (perm_bits & 0o777), self.uid, self.gid)


@dataclass(frozen=True)
class Credentials:
    """Client process identity used for permission checks (BAgent context)."""

    uid: int = 0
    gid: int = 0
    groups: tuple = ()

    def in_group(self, gid: int) -> bool:
        return gid == self.gid or gid in self.groups


def access_ok(perm: PermRecord, cred: Credentials, want: int,
              acl: Optional[List] = None, groups: Iterable[int] = ()) -> bool:
    """POSIX rwx check of `want` (mask of R_OK/W_OK/X_OK) against a record.

    This is the check the kernel performs per path component; in BuffetFS it
    runs on the *client* against cached parent-directory entries.

    `acl` is the optional per-file ACL that rides in the dentry next to the
    10-byte record (see `validate_acl` for the entry shape), and `groups`
    extends the credential's group set with memberships granted by the
    cluster-wide group table — they are what make the check "rich" without
    changing its 0-RPC character: both travel with (or are cached next to)
    the data the client already holds.  Evaluation order:

      * root keeps its POSIX shortcut (everything, except X on a file with
        no x bit anywhere) — ACLs cannot lock root out;
      * if any ACL entry MATCHES the caller (a "u" entry with its uid, or a
        "g" entry with a gid in cred.gid/cred.groups/`groups`), the ACL
        decides alone: `want` must be covered by the union of matching
        allow masks and must not touch any matching deny mask (deny wins);
      * otherwise the plain mode bits decide, exactly as before.
    """
    if cred.uid == 0:  # root: X still requires some x bit for files
        if want & X_OK and not perm.is_dir and not (perm.mode & 0o111):
            return False
        return True
    if acl:
        allowed = denied = 0
        matched = False
        for kind, ident, allow, deny in acl:
            if kind == "u":
                hit = ident == cred.uid
            else:
                hit = cred.in_group(ident) or ident in groups
            if hit:
                matched = True
                allowed |= allow
                denied |= deny
        if matched:
            return not (want & denied) and (allowed & want) == want
    if cred.uid == perm.uid:
        bits = (perm.mode >> 6) & 7
    elif cred.in_group(perm.gid):
        bits = (perm.mode >> 3) & 7
    else:
        bits = perm.mode & 7
    return (bits & want) == want


def validate_acl(acl: Optional[List]) -> Optional[List]:
    """Normalize/validate an ACL: a list of `[kind, id, allow, deny]` entries
    (kind "u"=user or "g"=group, id a uid/gid, allow/deny rwx masks 0..7).
    Entries are plain JSON-serializable lists so an ACL rides wire headers,
    the persist blob, and the replication log without any codec support.
    Returns the normalized list (or None for empty) and raises FSError
    EINVAL on malformed input."""
    if not acl:
        return None
    out: List[List] = []
    for entry in acl:
        try:
            kind, ident, allow, deny = entry
        except (TypeError, ValueError):
            raise err(errno.EINVAL, f"malformed ACL entry: {entry!r}")
        if (kind not in ("u", "g") or not isinstance(ident, int)
                or ident < 0 or not isinstance(allow, int)
                or not isinstance(deny, int)
                or not 0 <= allow <= 7 or not 0 <= deny <= 7):
            raise err(errno.EINVAL, f"malformed ACL entry: {entry!r}")
        out.append([kind, ident, allow, deny])
    return out


def normalize_groups(table: Optional[Dict]) -> Dict[int, List[int]]:
    """Group-membership table (uid -> extra gids) with int keys restored:
    the table crosses JSON boundaries (wire ext blob, persist blob, commit
    log), where object keys become strings."""
    if not table:
        return {}
    return {int(uid): [int(g) for g in gids] for uid, gids in table.items()}


def flags_to_access(flags: int) -> int:
    """Map open() flags to the rwx mask that must be satisfied on the file."""
    acc = flags & _ACCMODE
    if acc == O_RDONLY:
        want = R_OK
    elif acc == O_WRONLY:
        want = W_OK
    else:
        want = R_OK | W_OK
    if flags & (O_TRUNC | O_APPEND):
        want |= W_OK
    return want


class FSError(OSError):
    """errno-carrying error surfaced through BLib."""


def err(errno_: int, msg: str) -> FSError:
    e = FSError(errno_, msg)
    return e

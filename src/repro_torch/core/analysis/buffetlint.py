"""buffetlint — AST-based invariant lint for the port's BuffetFS core.

Three passes over `src/repro_torch/core`, each mechanizing a discipline that
until now lived only in comments and code review:

**1. Lock discipline** (LOCK001, LOCK002).  A declarative lock registry
(`LOCK_REGISTRY`) names the lock classes and their acquisition order:

    dir_mutex / groups_mutex  ->  file_lock  ->  chunk_lock  ->  server_lock

Outer classes have LOWER rank; `self._lock` (the server meta lock, which
also guards the lease table) is innermost and must never be held across a
blocking transport call — the InProc worker pool and the TCP pipelined
connections both assume handlers release it before fanning out (the
"handlers run OUTSIDE the lock" rule).  The pass builds a per-function
summary of lock classes held at every call site plus a conservative
intra-module call graph (including closures passed as arguments, so the
`_two_phase(check, apply)` scaffold is traversed), then reports

  * LOCK001: a blocking RPC (`transport.request` / `request_many`, or a
    known revoke/scatter fan-out helper) reachable while a *server-scope*
    lock class is held, and
  * LOCK002: any lock acquisition — direct or transitive through a call —
    whose class ranks at-or-below a class already held (ABBA inversion).

**2. Wire contract** (WIRE001-WIRE006).  Every server-side `MsgType` has
exactly one registered handler; `Operation` flags must cohere with what
the handler's call graph can reach (reaches `_revoke_leases` =>
`breaks_lease`, reaches `_journal`/`_jmeta` => `mutating` or `barrier`,
`barrier` => reaches a durability primitive before acking); verb numbers
are unique (IntEnum silently aliases duplicates); and every header key
written on an encode path is either a `_SLOT_DEFS` binary slot or an
allow-listed ext-JSON spill — adding a hot field without a slot becomes a
lint failure, not a silent 3.5x header regression.

**3. Counter hygiene** (CNT001-CNT003).  Every counter surfaced through a
stats surface (`io_stats()`, `RpcStats.snapshot()`, `repl_stats()`,
`ReplicationLog.stats()`, the page-cache stats) is actually set
somewhere; every counter that is incremented is readable somewhere (a
stats surface or a direct consumer — the gate files, by default
`chip_smoke.py`, read some counters straight off the objects); and gates
that name server counters by string (`_sum_srv(cluster, "...")`)
reference attributes that exist.

Findings carry file:line, a rule id and a fix hint.  Deliberate
violations are suppressed inline with

    # buffetlint: ignore[RULE001] reason why this is by design

(on the flagged line or the line above; the reason is mandatory —
META001 flags a bare suppression).  `--check` compares fingerprints
(line-number free, so unrelated edits don't invalidate them) against the
committed allow-list `src/repro_torch/core/analysis/baseline.json` and
fails only on NEW violations.  The CLI is
`python -m repro_torch.core.analysis [--check] [paths]`.

The rules, registries and findings are those of `repro.core.analysis`,
which lints the JAX package's copy of BuffetFS; this module imports
nothing of it (the fallback slot table is read from this package's own
`wire.py`).
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# Rule catalog
# ---------------------------------------------------------------------------

RULES: Dict[str, str] = {
    "LOCK001": "blocking RPC reachable while a server-scope lock is held",
    "LOCK002": "lock acquisition inverts the declared order (ABBA)",
    "WIRE001": "server MsgType has no registered handler",
    "WIRE002": "MsgType registered more than once",
    "WIRE003": "Operation flags incoherent with handler call graph",
    "WIRE004": "barrier verb never reaches a durability primitive",
    "WIRE005": "duplicate MsgType verb number (silent IntEnum alias)",
    "WIRE006": "header key is neither a _SLOT_DEFS slot nor an "
               "allow-listed ext-JSON key",
    "CNT001": "counter surfaced in a stats function but never set",
    "CNT002": "counter incremented but never surfaced or read",
    "CNT003": "benchmark gate names a counter that does not exist",
    "META001": "buffetlint suppression without a reason",
}

# ---------------------------------------------------------------------------
# Lock registry — the declared acquisition order.
#
# Rank increases inward: a lock may be acquired while holding any lock of
# strictly lower rank, never one of equal-or-higher rank (same class
# re-entry is allowed: the server lock is an RLock, and per-entity classes
# only nest on distinct entities by construction).  `scope == "server"`
# marks process-wide locks that must not be held across blocking RPCs;
# per-entity locks MAY be (the truncate/fsync/scrub-clip chunk fan-outs
# run under the per-file lock by design — that is their serialization).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LockClass:
    name: str        # registry name, used in findings and the recorder
    attr: str        # attribute spelled in `with self.<attr>...`
    callable: bool   # True: `with self.attr(...)`; False: `with self.attr`
    rank: int        # acquisition order; lower = outer
    scope: str       # "server" | "per-directory" | "per-file" | "per-chunk"


LOCK_REGISTRY: Tuple[LockClass, ...] = (
    LockClass("dir_mutex", "_dir_mutex", True, 10, "per-directory"),
    LockClass("groups_mutex", "_groups_mutex", False, 10, "server"),
    LockClass("file_lock", "_file_lock", True, 20, "per-file"),
    LockClass("chunk_lock", "_chunk_lock", True, 30, "per-chunk"),
    # the server meta lock also guards the lease table (BServer._leases)
    LockClass("server_lock", "_lock", False, 40, "server"),
)

_LOCK_BY_ATTR: Dict[Tuple[str, bool], LockClass] = {
    (c.attr, c.callable): c for c in LOCK_REGISTRY
}
LOCK_RANK: Dict[str, int] = {c.name: c.rank for c in LOCK_REGISTRY}
SERVER_SCOPE: FrozenSet[str] = frozenset(
    c.name for c in LOCK_REGISTRY if c.scope == "server")

# Attribute names whose *call* blocks on the network.  `request` and
# `request_many` are the transport primitives; the rest are fan-out
# helpers that loop transport calls and may be reached across module
# boundaries (`self.server._repl_send(...)`), where the intra-module call
# graph cannot see their bodies.
BLOCKING_CALL_ATTRS: FrozenSet[str] = frozenset({
    "request", "request_many",
})
BLOCKING_HELPER_NAMES: FrozenSet[str] = frozenset({
    "_invalidate_watchers", "_revoke_leases", "_invalidate_group_watchers",
    "_fanout_chunks", "_request_host", "_repl_send", "_hb_request",
})

# Durability primitives a `barrier` verb must reach before acking.
DURABILITY_NAMES: FrozenSet[str] = frozenset({"_persist_now", "fsync"})

# Mutation-note helpers: reaching one of these means the handler commits
# a change to the journal/commit log, so it must be flagged mutating (or
# barrier — FSYNC flushes previously journaled state).
MUTATION_NOTE_NAMES: FrozenSet[str] = frozenset({"_journal", "_jmeta"})

# Client-callback and control verbs that legitimately have no entry in
# SERVER_OPS: INVALIDATE / REVOKE_LEASE are dispatched by the *agent*
# (BAgent._handle_callback); OK/ERROR are response types; BATCH is
# unwrapped by the transport envelope layer.
UNHANDLED_VERBS: Dict[str, str] = {
    "INVALIDATE": "client callback (BAgent._handle_callback)",
    "REVOKE_LEASE": "client callback (BAgent._handle_callback)",
    "OK": "response type",
    "ERROR": "response type",
    "BATCH": "transport envelope",
}

# Ext-JSON spill keys allowed on encode paths.  Everything here rides
# cold verbs (namespace mutations, scrub/replication control, baselines)
# where one JSON spill per RPC is noise; hot-verb fields (READ/WRITE/
# CHUNK_* data plane) must be `_SLOT_DEFS` slots — add a slot, not an
# entry here, or the binary header's win silently erodes.
EXT_ALLOWED: FrozenSet[str] = frozenset({
    # error responses
    "msg",
    # namespace verbs: paths, names, dentry payloads
    "parent", "name", "old", "new", "entries", "dirs", "perm", "mode",
    "uid", "gid", "ino", "dir_ino", "names", "is_dir", "depth", "e",
    "existed", "frontier", "nlink", "atime", "mtime", "ctime",
    # open/lease records and client registration (CLOSE is async and
    # off the critical path; pid/fd identify the opened-file record)
    "client_id", "cb_addr", "record", "incomplete_open", "host", "pid",
    "fd", "host_id",
    # striped-WRITE commit: a variable-length [[offset, len], ...]
    # extent list — structurally unable to be a fixed-width slot, so it
    # rides the ext blob like the request-side lease record (see the
    # _SLOT_DEFS comment); revisit if profiles show it dominating
    "commit",
    # striping control (layout dicts ride LOOKUP/CREATE responses)
    "layout", "ops", "indices", "chunks", "requester", "dead",
    "chunks_clipped", "bytes_clipped", "crc", "crcs", "push",
    # permissions / group table (SETACL, SETGROUPS, LOOKUP_GROUPS)
    "acl", "groups", "gids",
    # replication / failover control plane
    "hver", "seq", "recs", "acked", "resync", "snap", "standby",
    "version", "counts", "addr", "records", "reaped",
    # heartbeat / monitor view
    "view", "hb_seen",
})

# Stats surfaces: (module stem, function qualname).  An attribute read
# inside one of these functions "surfaces" that counter.
SURFACE_FUNCS: FrozenSet[Tuple[str, str]] = frozenset({
    ("blib", "BLib.io_stats"),
    ("wire", "RpcStats.snapshot"),
    ("bagent", "_PageCache.stats"),
    ("bagent", "BAgent.cache_stats"),
    ("bserver", "BServer.repl_stats"),
    ("repl", "ReplicationLog.stats"),
})

# Classes whose `self.X = 0` __init__ attributes are treated as counters.
COUNTER_CLASSES: FrozenSet[str] = frozenset({
    "BServer", "BAgent", "_PageCache", "ReplicationLog", "ReplicaStore",
    "RpcStats", "BuffetCluster",
})

_SUPPRESS_RE = re.compile(
    r"#\s*buffetlint:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*)")


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    rule: str
    path: str          # scan-root-relative, stable across checkouts
    line: int
    symbol: str        # function/class/verb the finding anchors to
    message: str
    hint: str
    detail: str = ""   # stable discriminator for the fingerprint

    @property
    def fingerprint(self) -> str:
        # deliberately line-number free so unrelated edits above the
        # finding do not invalidate a baseline entry
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.symbol}] "
                f"{self.message}\n    hint: {self.hint}")


# ---------------------------------------------------------------------------
# Per-module AST scan
# ---------------------------------------------------------------------------


@dataclass
class CallSite:
    name: str                  # last dotted component of the callee
    kind: str                  # "self" | "attr" | "bare"
    held: Tuple[str, ...]      # lock classes held, outermost first
    line: int
    arg_names: Tuple[str, ...]  # bare-Name arguments (closure candidates)


@dataclass
class Acquisition:
    lock: str
    held: Tuple[str, ...]
    line: int


@dataclass
class FuncInfo:
    qualname: str
    class_name: Optional[str]
    lineno: int
    calls: List[CallSite] = field(default_factory=list)
    acquisitions: List[Acquisition] = field(default_factory=list)
    nested: Set[str] = field(default_factory=set)


@dataclass
class Registration:
    verb: str
    flags: Dict[str, bool]
    func: str
    line: int


@dataclass
class HeaderKey:
    key: str
    line: int
    func: str


@dataclass
class ModuleScan:
    path: Path
    rel: str
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, Set[str]] = field(default_factory=dict)  # methods
    registrations: List[Registration] = field(default_factory=list)
    header_keys: List[HeaderKey] = field(default_factory=list)
    msg_types: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    slot_names: List[str] = field(default_factory=list)
    # counters: class -> name -> first line
    counter_inits: Dict[str, Dict[str, int]] = field(default_factory=dict)
    attr_inits: Dict[str, Set[str]] = field(default_factory=dict)
    properties: Dict[str, Set[str]] = field(default_factory=dict)
    attr_loads: Dict[str, List[Tuple[str, int]]] = field(
        default_factory=dict)  # func qualname -> [(attr, line)]
    # attribute names written with a non-zero value anywhere (any
    # receiver, not just self: promote_peer sets srv.promoted_records)
    attr_stores: Set[str] = field(default_factory=set)
    sum_srv_refs: List[Tuple[str, int]] = field(default_factory=list)
    suppressions: Dict[int, Tuple[Set[str], str]] = field(
        default_factory=dict)
    comment_lines: Set[int] = field(default_factory=set)


def _classify_lock(expr: ast.expr) -> Optional[LockClass]:
    """`with self._lock:` / `with self._file_lock(fid):` -> LockClass."""
    if isinstance(expr, ast.Attribute):
        return _LOCK_BY_ATTR.get((expr.attr, False))
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        return _LOCK_BY_ATTR.get((expr.func.attr, True))
    return None


def _callee(func: ast.expr) -> Optional[Tuple[str, str]]:
    """Callee name + kind: self-method, attribute call, or bare name."""
    if isinstance(func, ast.Attribute):
        if isinstance(func.value, ast.Name) and func.value.id == "self":
            return func.attr, "self"
        return func.attr, "attr"
    if isinstance(func, ast.Name):
        return func.id, "bare"
    return None


class _Scanner:
    """One pass over a module collecting everything the rules consume."""

    def __init__(self, path: Path, rel: str, tree: ast.Module,
                 source: str) -> None:
        self.scan = ModuleScan(path=path, rel=rel)
        self._collect_suppressions(source)
        for node in tree.body:
            self._top_level(node)

    # -- comments -------------------------------------------------------

    def _collect_suppressions(self, source: str) -> None:
        for i, text in enumerate(source.splitlines(), start=1):
            if text.lstrip().startswith("#"):
                self.scan.comment_lines.add(i)
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.scan.suppressions[i] = (rules, m.group(2).strip())

    # -- top level ------------------------------------------------------

    def _top_level(self, node: ast.stmt) -> None:
        if isinstance(node, ast.ClassDef):
            self.scan.classes[node.name] = set()
            self.scan.properties[node.name] = set()
            self.scan.counter_inits.setdefault(node.name, {})
            self.scan.attr_inits.setdefault(node.name, set())
            if node.name == "MsgType":
                self._msg_type(node)
                return
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.scan.classes[node.name].add(item.name)
                    if any(isinstance(d, ast.Name) and d.id == "property"
                           for d in item.decorator_list):
                        self.scan.properties[node.name].add(item.name)
                    self._function(item, node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._function(node, None)
        elif isinstance(node, ast.Assign):
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                self._maybe_slot_defs(node.targets[0].id, node.value)
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) and node.value is not None:
                self._maybe_slot_defs(node.target.id, node.value)

    def _msg_type(self, node: ast.ClassDef) -> None:
        for item in node.body:
            if (isinstance(item, ast.Assign) and len(item.targets) == 1
                    and isinstance(item.targets[0], ast.Name)
                    and isinstance(item.value, ast.Constant)
                    and isinstance(item.value.value, int)):
                self.scan.msg_types[item.targets[0].id] = (
                    item.value.value, item.lineno)

    def _maybe_slot_defs(self, name: str, value: ast.expr) -> None:
        if name != "_SLOT_DEFS":
            return
        if isinstance(value, ast.Tuple):
            for elt in value.elts:
                if (isinstance(elt, ast.Tuple) and elt.elts
                        and isinstance(elt.elts[0], ast.Constant)):
                    self.scan.slot_names.append(elt.elts[0].value)

    # -- functions ------------------------------------------------------

    def _function(self, node: ast.stmt, class_name: Optional[str],
                  prefix: str = "") -> None:
        name = node.name  # type: ignore[attr-defined]
        qual = (f"{prefix}.{name}" if prefix
                else (f"{class_name}.{name}" if class_name else name))
        info = FuncInfo(qual, class_name, node.lineno)
        self.scan.functions[qual] = info
        self.scan.attr_loads[qual] = []
        self._registration(node, qual)
        is_init = name == "__init__"
        # dict literals assigned to locals, for header-key tracking
        local_dicts: Dict[str, Tuple[List[Tuple[str, int]], int]] = {}

        def record_dict_keys(d: ast.Dict) -> List[Tuple[str, int]]:
            keys = []
            for k in d.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.append((k.value, k.lineno))
            return keys

        def header_arg(call: ast.Call, idx: int) -> None:
            args = call.args
            if len(args) > idx:
                a = args[idx]
                if isinstance(a, ast.Dict):
                    for key, line in record_dict_keys(a):
                        self.scan.header_keys.append(HeaderKey(key, line, qual))
                elif isinstance(a, ast.Name) and a.id in local_dicts:
                    for key, line in local_dicts[a.id][0]:
                        self.scan.header_keys.append(HeaderKey(key, line, qual))

        def walk(n: ast.AST, held: List[str]) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.nested.add(n.name)
                self._function(n, class_name, prefix=qual)
                return
            if isinstance(n, ast.Lambda):
                return
            if isinstance(n, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in n.items:
                    lc = _classify_lock(item.context_expr)
                    if lc is not None:
                        info.acquisitions.append(
                            Acquisition(lc.name, tuple(inner),
                                        item.context_expr.lineno))
                        inner.append(lc.name)
                    else:
                        walk(item.context_expr, held)
                        if item.optional_vars is not None:
                            walk(item.optional_vars, held)
                for stmt in n.body:
                    walk(stmt, inner)
                return
            if isinstance(n, ast.Assign):
                # `h = {...}` for later Message(t, h) header tracking
                if (len(n.targets) == 1 and isinstance(n.targets[0], ast.Name)
                        and isinstance(n.value, ast.Dict)):
                    local_dicts[n.targets[0].id] = (
                        record_dict_keys(n.value), n.lineno)
                self._counter_assign(n, class_name, is_init)
            if isinstance(n, ast.AugAssign):
                self._counter_aug(n, class_name)
            if isinstance(n, ast.Call):
                cal = _callee(n.func)
                if cal is not None:
                    cname, kind = cal
                    arg_names = tuple(
                        a.id for a in list(n.args) + [
                            kw.value for kw in n.keywords]
                        if isinstance(a, ast.Name))
                    info.calls.append(
                        CallSite(cname, kind, tuple(held), n.lineno,
                                 arg_names))
                    if cname == "Message":
                        header_arg(n, 1)
                    elif cname == "ok":
                        header_arg(n, 0)
                    elif cname == "_sum_srv" and len(n.args) >= 2:
                        a = n.args[1]
                        if (isinstance(a, ast.Constant)
                                and isinstance(a.value, str)):
                            self.scan.sum_srv_refs.append((a.value, a.lineno))
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store):
                # resp.header["k"] = v  — a post-hoc header write
                if (isinstance(n.value, ast.Attribute)
                        and n.value.attr == "header"
                        and isinstance(n.slice, ast.Constant)
                        and isinstance(n.slice.value, str)):
                    self.scan.header_keys.append(
                        HeaderKey(n.slice.value, n.lineno, qual))
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                self.scan.attr_loads[qual].append((n.attr, n.lineno))
            for child in ast.iter_child_nodes(n):
                walk(child, held)

        for stmt in node.body:  # type: ignore[attr-defined]
            walk(stmt, [])

    def _registration(self, node: ast.stmt, qual: str) -> None:
        for dec in node.decorator_list:  # type: ignore[attr-defined]
            if not (isinstance(dec, ast.Call)
                    and isinstance(dec.func, ast.Attribute)
                    and dec.func.attr == "register"):
                continue
            if not dec.args:
                continue
            verb = dec.args[0]
            if not (isinstance(verb, ast.Attribute)
                    and isinstance(verb.value, ast.Name)
                    and verb.value.id == "MsgType"):
                continue
            flags = {}
            for kw in dec.keywords:
                if isinstance(kw.value, ast.Constant):
                    flags[kw.arg] = bool(kw.value.value)
            self.scan.registrations.append(
                Registration(verb.attr, flags, qual, dec.lineno))

    # -- counters -------------------------------------------------------

    def _counter_assign(self, n: ast.Assign, class_name: Optional[str],
                        is_init: bool) -> None:
        zero = isinstance(n.value, ast.Constant) and n.value.value == 0
        for tgt in n.targets:
            if not isinstance(tgt, ast.Attribute):
                continue
            is_self = (isinstance(tgt.value, ast.Name)
                       and tgt.value.id == "self")
            name = tgt.attr
            if is_self and is_init and class_name in COUNTER_CLASSES:
                self.scan.attr_inits[class_name].add(name)
                if zero and not name.startswith("_"):
                    self.scan.counter_inits[class_name].setdefault(
                        name, n.lineno)
            elif not zero:
                # a non-zero assignment anywhere — including through a
                # non-self receiver — produces the counter's value; a
                # literal zero is a reset, not production
                self.scan.attr_stores.add(name)

    def _counter_aug(self, n: ast.AugAssign, class_name: Optional[str]) -> None:
        if isinstance(n.target, ast.Attribute):
            self.scan.attr_stores.add(n.target.attr)


# ---------------------------------------------------------------------------
# Analyzer: cross-module rule evaluation
# ---------------------------------------------------------------------------


class Analyzer:
    def __init__(self, scans: List[ModuleScan],
                 bench_scans: Optional[List[ModuleScan]] = None) -> None:
        self.scans = scans
        self.bench_scans = bench_scans or []
        self.findings: List[Finding] = []
        # global function table: qualname -> (scan, FuncInfo); names are
        # module-qualified to keep same-named methods apart
        self.funcs: Dict[str, Tuple[ModuleScan, FuncInfo]] = {}
        for s in scans:
            for q, fi in s.functions.items():
                self.funcs[f"{s.rel}::{q}"] = (s, fi)
        self._edges = self._build_edges()
        self._may_block = self._fixpoint_may_block()
        self._acquires = self._fixpoint_acquires()
        self._reaches = self._fixpoint_reaches(
            BLOCKING_HELPER_NAMES | MUTATION_NOTE_NAMES | DURABILITY_NAMES)

    # -- call graph -----------------------------------------------------

    def _resolve(self, scan: ModuleScan, caller: FuncInfo,
                 site: CallSite) -> List[str]:
        """Resolve a call site to module-local function keys."""
        out: List[str] = []

        def add(qual: str) -> None:
            key = f"{scan.rel}::{qual}"
            if key in self.funcs:
                out.append(key)

        if site.kind == "self" and caller.class_name:
            if site.name in scan.classes.get(caller.class_name, ()):
                add(f"{caller.class_name}.{site.name}")
        elif site.kind == "bare":
            if site.name in scan.functions:
                add(site.name)
            # closure defined in this function (or passed down by name)
            add(f"{caller.qualname}.{site.name}")
        # closures handed as arguments: `self._two_phase(p, n, check, apply)`
        for arg in site.arg_names:
            if arg in caller.nested:
                add(f"{caller.qualname}.{arg}")
        return out

    def _build_edges(self) -> Dict[str, List[Tuple[str, CallSite]]]:
        edges: Dict[str, List[Tuple[str, CallSite]]] = {}
        for key, (scan, fi) in self.funcs.items():
            lst = []
            for site in fi.calls:
                for callee in self._resolve(scan, fi, site):
                    lst.append((callee, site))
            edges[key] = lst
        return edges

    def _site_blocks_directly(self, site: CallSite) -> bool:
        if site.kind == "attr" and site.name in BLOCKING_CALL_ATTRS:
            return True
        # cross-module fan-out helper spelled through another object
        # (self.server._repl_send, cluster._hb_request, ...)
        if site.kind in ("attr", "self") and site.name in BLOCKING_HELPER_NAMES:
            # self-calls resolve through the graph when the helper is in
            # the same class; the name fallback covers cross-module ones
            return True
        return False

    def _fixpoint_may_block(self) -> Dict[str, bool]:
        may: Dict[str, bool] = {}
        for key, (_, fi) in self.funcs.items():
            may[key] = any(self._site_blocks_directly(s) for s in fi.calls)
        changed = True
        while changed:
            changed = False
            for key, lst in self._edges.items():
                if may[key]:
                    continue
                if any(may[callee] for callee, _ in lst):
                    may[key] = True
                    changed = True
        return may

    def _fixpoint_acquires(self) -> Dict[str, Set[str]]:
        acq: Dict[str, Set[str]] = {
            key: {a.lock for a in fi.acquisitions}
            for key, (_, fi) in self.funcs.items()
        }
        changed = True
        while changed:
            changed = False
            for key, lst in self._edges.items():
                for callee, _ in lst:
                    extra = acq[callee] - acq[key]
                    if extra:
                        acq[key] |= extra
                        changed = True
        return acq

    def _fixpoint_reaches(self, targets: FrozenSet[str]
                          ) -> Dict[str, Set[str]]:
        """For each function: which of `targets` its call graph reaches
        (by callee name, including unresolved attribute calls)."""
        reach: Dict[str, Set[str]] = {}
        for key, (_, fi) in self.funcs.items():
            reach[key] = {s.name for s in fi.calls if s.name in targets}
        changed = True
        while changed:
            changed = False
            for key, lst in self._edges.items():
                for callee, _ in lst:
                    extra = reach[callee] - reach[key]
                    if extra:
                        reach[key] |= extra
                        changed = True
        return reach

    # -- reporting ------------------------------------------------------

    def _emit(self, scan: ModuleScan, finding: Finding) -> None:
        # a suppression applies on the flagged line itself or anywhere in
        # the contiguous comment block immediately above it (multi-line
        # reasons are encouraged)
        sup = scan.suppressions.get(finding.line)
        line = finding.line - 1
        while sup is None and line in scan.comment_lines:
            sup = scan.suppressions.get(line)
            line -= 1
        if sup is not None:
            rules, reason = sup
            if finding.rule in rules or "*" in rules:
                if not reason:
                    self.findings.append(Finding(
                        "META001", scan.rel, finding.line, finding.symbol,
                        f"suppression of {finding.rule} has no reason",
                        "append a justification after the closing bracket: "
                        "# buffetlint: ignore[RULE] why this is by design",
                        detail=finding.detail))
                return
        self.findings.append(finding)

    # -- pass 1: lock discipline ---------------------------------------

    def pass_locks(self) -> None:
        for key, (scan, fi) in self.funcs.items():
            # LOCK001: blocking call while a server-scope lock is held
            for site in fi.calls:
                held_server = [h for h in site.held if h in SERVER_SCOPE]
                if not held_server:
                    continue
                blocking = self._site_blocks_directly(site)
                via = site.name
                if not blocking:
                    for callee, s2 in self._edges.get(key, ()):
                        if s2 is site and self._may_block[callee]:
                            blocking = True
                            via = callee.split("::", 1)[1]
                            break
                if blocking:
                    self._emit(scan, Finding(
                        "LOCK001", scan.rel, site.line, fi.qualname,
                        f"call to `{via}` can block on a transport RPC "
                        f"while holding {held_server[0]}",
                        "snapshot the state you need under the lock, "
                        "release it, then fan out (see "
                        "_invalidate_watchers / _revoke_leases)",
                        detail=f"{site.name}@{held_server[0]}"))
            # LOCK002: direct inversions
            for acq in fi.acquisitions:
                self._check_order(scan, fi, acq.lock, acq.held, acq.line,
                                  via=None)
            # LOCK002: transitive inversions through calls
            for callee, site in self._edges.get(key, ()):
                if not site.held:
                    continue
                for lock in self._acquires[callee]:
                    self._check_order(scan, fi, lock, site.held, site.line,
                                      via=callee.split("::", 1)[1])

    def _check_order(self, scan: ModuleScan, fi: FuncInfo, lock: str,
                     held: Tuple[str, ...], line: int,
                     via: Optional[str]) -> None:
        for h in held:
            if lock == h:
                continue  # re-entry (RLock) / distinct entities by design
            if LOCK_RANK[lock] <= LOCK_RANK[h]:
                how = f"via `{via}` " if via else ""
                self._emit(scan, Finding(
                    "LOCK002", scan.rel, line, fi.qualname,
                    f"acquires {lock} (rank {LOCK_RANK[lock]}) {how}while "
                    f"holding {h} (rank {LOCK_RANK[h]}); declared order is "
                    "dir_mutex/groups_mutex -> file_lock -> chunk_lock -> "
                    "server_lock",
                    "restructure so the outer-ranked lock is taken first, "
                    "or release the inner lock before this acquisition",
                    detail=f"{lock}<{h}" + (f"@{via}" if via else "")))
                return

    # -- pass 2: wire contract -----------------------------------------

    def pass_wire(self) -> None:
        wire_scan = next((s for s in self.scans if s.msg_types), None)
        msg_types = wire_scan.msg_types if wire_scan else {}
        slots = set()
        for s in self.scans:
            slots.update(s.slot_names)

        # WIRE005: duplicate verb numbers (IntEnum aliases silently)
        if wire_scan is not None:
            by_num: Dict[int, str] = {}
            for name, (num, line) in sorted(
                    msg_types.items(), key=lambda kv: kv[1][1]):
                if num in by_num:
                    self._emit(wire_scan, Finding(
                        "WIRE005", wire_scan.rel, line, name,
                        f"verb number {num} already used by "
                        f"{by_num[num]} — IntEnum makes this a silent "
                        "alias, not a new verb",
                        "pick the next unused number (append-only keeps "
                        "the wire compatible)",
                        detail=f"{name}={num}"))
                else:
                    by_num[num] = name

        # registrations across all modules
        by_verb: Dict[str, List[Tuple[ModuleScan, Registration]]] = {}
        for s in self.scans:
            for reg in s.registrations:
                by_verb.setdefault(reg.verb, []).append((s, reg))

        # WIRE002: duplicates (the registry raises at import, but only on
        # the module actually imported — a copy-pasted decorator in a
        # module CI never imports would hide until production)
        for verb, regs in sorted(by_verb.items()):
            if len(regs) > 1:
                for s, reg in regs[1:]:
                    self._emit(s, Finding(
                        "WIRE002", s.rel, reg.line, verb,
                        f"MsgType.{verb} is registered more than once "
                        f"(first: {regs[0][0].rel}::{regs[0][1].func})",
                        "one verb, one handler: delete or renumber one "
                        "of the registrations",
                        detail=reg.func))

        # WIRE001: unhandled server verbs (only meaningful when the scan
        # saw the wire module AND the handler modules)
        if wire_scan is not None and by_verb:
            for name, (num, line) in sorted(msg_types.items()):
                if name in by_verb or name in UNHANDLED_VERBS:
                    continue
                self._emit(wire_scan, Finding(
                    "WIRE001", wire_scan.rel, line, name,
                    f"MsgType.{name} ({num}) has no registered handler",
                    "register a handler with @SERVER_OPS.register("
                    f"MsgType.{name}) or allow-list it in "
                    "UNHANDLED_VERBS with the dispatching component",
                    detail=str(num)))

        # WIRE003/WIRE004: flag coherence against handler reachability
        for verb, regs in sorted(by_verb.items()):
            for s, reg in regs:
                key = f"{s.rel}::{reg.func}"
                reach = self._reaches.get(key, set())
                flags = reg.flags
                mutating = flags.get("mutating", False)
                barrier = flags.get("barrier", False)
                breaks = flags.get("breaks_lease", False)
                if "_revoke_leases" in reach and not breaks:
                    self._emit(s, Finding(
                        "WIRE003", s.rel, reg.line, verb,
                        f"handler {reg.func} reaches _revoke_leases but "
                        "is not flagged breaks_lease",
                        "add breaks_lease=True to the registration (or "
                        "stop recalling leases from this verb)",
                        detail="breaks_lease-missing"))
                if breaks and "_revoke_leases" not in reach:
                    self._emit(s, Finding(
                        "WIRE003", s.rel, reg.line, verb,
                        f"handler {reg.func} is flagged breaks_lease but "
                        "never reaches _revoke_leases",
                        "drop the stale flag or call _revoke_leases on "
                        "the mutation path",
                        detail="breaks_lease-stale"))
                if (reach & MUTATION_NOTE_NAMES) and not (mutating or barrier):
                    self._emit(s, Finding(
                        "WIRE003", s.rel, reg.line, verb,
                        f"handler {reg.func} journals "
                        f"({', '.join(sorted(reach & MUTATION_NOTE_NAMES))}) "
                        "but is not flagged mutating",
                        "add mutating=True so replication/standby logic "
                        "sees this verb as a state change",
                        detail="mutating-missing"))
                if barrier and not (reach & DURABILITY_NAMES):
                    self._emit(s, Finding(
                        "WIRE004", s.rel, reg.line, verb,
                        f"barrier verb {verb} never reaches a durability "
                        "primitive (_persist_now / os.fsync) before acking",
                        "a barrier ack promises durability: flush before "
                        "returning ok()",
                        detail=reg.func))

        # WIRE006: header keys on encode paths
        if slots:
            for s in self.scans:
                seen: Set[str] = set()
                for hk in s.header_keys:
                    if hk.key in slots or hk.key in EXT_ALLOWED:
                        continue
                    if (hk.key, hk.func) in seen:
                        continue
                    seen.add((hk.key, hk.func))
                    self._emit(s, Finding(
                        "WIRE006", s.rel, hk.line, hk.func,
                        f"header key \"{hk.key}\" is neither a _SLOT_DEFS "
                        "slot nor an allow-listed ext-JSON key",
                        "hot-path fields get a binary slot in "
                        "wire._SLOT_DEFS (append-only); cold control "
                        "fields get an EXT_ALLOWED entry with a comment",
                        detail=hk.key))

    # -- pass 3: counter hygiene ---------------------------------------

    def pass_counters(self) -> None:
        # union of counters per class across modules
        inits: Dict[Tuple[str, str], Tuple[ModuleScan, int]] = {}
        set_names: Set[str] = set()
        for s in self.scans:
            for cls, names in s.counter_inits.items():
                for name, line in names.items():
                    inits[(cls, name)] = (s, line)
            set_names |= s.attr_stores

        # every attribute-load site, by name (core + gate files)
        loads: Dict[str, List[Tuple[ModuleScan, str, int]]] = {}
        surfaced: Set[str] = set()
        for s in self.scans + self.bench_scans:
            for func, lst in s.attr_loads.items():
                for attr, line in lst:
                    loads.setdefault(attr, []).append((s, func, line))
                    if (Path(s.rel).stem, func) in SURFACE_FUNCS:
                        surfaced.add(attr)

        # CNT001: surfaced but never set anywhere
        for (cls, name), (s, line) in sorted(inits.items()):
            if name not in surfaced or name in set_names:
                continue
            surf = next(((ss, f, ln) for ss, f, ln in loads.get(name, ())
                         if (Path(ss.rel).stem, f) in SURFACE_FUNCS), None)
            where, func, ln = surf if surf else (s, cls, line)
            self._emit(where, Finding(
                "CNT001", where.rel, ln, func,
                f"counter {cls}.{name} is surfaced but never "
                "incremented or assigned anywhere",
                "wire up the increment, or delete the dead counter "
                "(if it is pinned at zero by design, suppress with a "
                "reason)",
                detail=f"{cls}.{name}"))

        # CNT002: set but never surfaced or read anywhere else
        for (cls, name), (s, line) in sorted(inits.items()):
            if name not in set_names:
                continue  # never produced: CNT001 territory
            if name in surfaced:
                continue
            if loads.get(name):
                continue  # consumed directly (gates/tests read the attr)
            # anchor at the init line: the increment may move, the
            # declaration is the counter's identity
            self._emit(s, Finding(
                "CNT002", s.rel, line, cls,
                f"counter {cls}.{name} is incremented but never surfaced "
                "by a stats function or read by any gate",
                "expose it via the class's stats surface (io_stats / "
                "repl_stats / snapshot) or delete it",
                detail=f"{cls}.{name}"))

        # CNT003: benchmark string-named server counters must exist
        server_attrs: Set[str] = set()
        for s in self.scans:
            server_attrs |= s.attr_inits.get("BServer", set())
            server_attrs |= s.properties.get("BServer", set())
        if server_attrs:
            for s in self.bench_scans:
                for name, line in s.sum_srv_refs:
                    if name in server_attrs:
                        continue
                    self._emit(s, Finding(
                        "CNT003", s.rel, line, Path(s.rel).stem,
                        f"_sum_srv names \"{name}\" but BServer has no "
                        "such attribute — the gate would raise (or worse, "
                        "silently gate a renamed counter's ghost)",
                        "point the gate at the real counter name",
                        detail=name))


# ---------------------------------------------------------------------------
# Running the passes
# ---------------------------------------------------------------------------


def _scan_tree(paths: Sequence[Path]) -> List[ModuleScan]:
    scans: List[ModuleScan] = []
    for root in paths:
        files: List[Tuple[Path, str]]
        if root.is_file():
            files = [(root, root.name)]
        else:
            files = sorted(
                (p, p.relative_to(root).as_posix())
                for p in root.rglob("*.py"))
        for path, rel in files:
            source = path.read_text()
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                raise SystemExit(f"buffetlint: cannot parse {path}: {e}")
            scans.append(_Scanner(path, rel, tree, source).scan)
    return scans


# this package's own wire module: the slot table of the fallback scan
WIRE_PY = Path(__file__).resolve().parents[1] / "wire.py"
# the repo's root, which the CLI's defaults are resolved against
REPO_ROOT = Path(__file__).resolve().parents[4]


def _fallback_wire_scan(scans: List[ModuleScan]) -> None:
    """Fixture trees without a wire.py still need the slot table: fall
    back to this package's own `wire.py` (read as source, not imported)
    so WIRE006 keeps its teeth."""
    if any(s.slot_names for s in scans):
        return
    path = WIRE_PY
    if not path.is_file():
        return
    source = path.read_text()
    scanner = _Scanner(path, path.name, ast.parse(source), source)
    # only the slot table — msg types / registrations of the real tree
    # must not leak coverage findings into a fixture scan
    donor = ModuleScan(path=path, rel=path.name)
    donor.slot_names = scanner.scan.slot_names
    scans.append(donor)


def lint_paths(paths: Sequence[Path],
               bench_paths: Sequence[Path] = ()) -> List[Finding]:
    scans = _scan_tree(paths)
    _fallback_wire_scan(scans)
    bench = _scan_tree(bench_paths) if bench_paths else []
    an = Analyzer(scans, bench)
    an.pass_locks()
    an.pass_wire()
    an.pass_counters()
    order = {rule: i for i, rule in enumerate(RULES)}
    an.findings.sort(key=lambda f: (order.get(f.rule, 99), f.path, f.line))
    return an.findings


def load_baseline(path: Path) -> Dict[str, str]:
    """fingerprint -> reason.  A missing baseline is an empty allow-list."""
    if not path.exists():
        return {}
    blob = json.loads(path.read_text())
    return {e["fingerprint"]: e.get("reason", "")
            for e in blob.get("allow", [])}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis",
        description="AST-based lock-discipline / wire-contract / "
                    "counter-hygiene lint for the port's BuffetFS core")
    ap.add_argument("paths", nargs="*",
                    default=[str(REPO_ROOT / "src" / "repro_torch" / "core")],
                    help="files or directories to scan "
                         "(default: src/repro_torch/core)")
    ap.add_argument("--benchmarks", action="append",
                    help="a file or directory whose code reads counters as "
                         "gates, scanned for CNT002's direct reads and "
                         "CNT003's _sum_srv names; repeatable (default: "
                         "chip_smoke.py; a missing path is ignored)")
    ap.add_argument("--baseline",
                    default=str(Path(__file__).with_name("baseline.json")),
                    help="committed allow-list of grandfathered findings "
                         "(default: src/repro_torch/core/analysis/"
                         "baseline.json)")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on findings not in the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths]
    for p in paths:
        if not p.exists():
            print(f"buffetlint: no such path: {p}", file=sys.stderr)
            return 2
    gates = args.benchmarks or [str(REPO_ROOT / "chip_smoke.py")]
    bench_paths = [Path(b) for b in gates if Path(b).exists()]
    findings = lint_paths(paths, bench_paths)

    if args.update_baseline:
        blob = {
            "comment": "buffetlint grandfathered findings; regenerate "
                       "with python -m repro_torch.core.analysis "
                       "--update-baseline after triaging any new finding "
                       "as deliberate",
            "allow": [{"fingerprint": f.fingerprint,
                       "rule": f.rule,
                       "reason": f.message} for f in findings],
        }
        out = Path(args.baseline)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(blob, indent=1, sort_keys=True) + "\n")
        print(f"baseline rewritten: {len(findings)} allow-listed "
              f"-> {args.baseline}")
        return 0

    allow = load_baseline(Path(args.baseline)) if args.check else {}
    new = [f for f in findings if f.fingerprint not in allow]
    grandfathered = len(findings) - len(new)

    if args.as_json:
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line,
            "symbol": f.symbol, "message": f.message, "hint": f.hint,
            "fingerprint": f.fingerprint,
        } for f in (new if args.check else findings)], indent=1))
    else:
        for f in (new if args.check else findings):
            print(f.render())

    if args.check:
        stale = set(allow) - {f.fingerprint for f in findings}
        for fp in sorted(stale):
            print(f"note: baseline entry no longer fires "
                  f"(safe to drop): {fp}")
        if new:
            print(f"buffetlint: {len(new)} new finding(s) "
                  f"({grandfathered} grandfathered)", file=sys.stderr)
            return 1
        print(f"buffetlint: clean ({grandfathered} grandfathered, "
              f"{len(allow)} baselined)")
        return 0
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""`repro_torch.core.analysis.buffetlint`, the port's copy of the BuffetFS
lint, held finding for finding to `repro.core.analysis.buffetlint`.

* Every rule fixture of `tests/test_buffetlint.py` (its own copy here) is
  linted by both: the same findings (rule, path, line, symbol, message,
  hint, detail, fingerprint) and the rules each fixture is written to show.
* Both live trees by both lints: the JAX tree with its benchmarks clean;
  the port's tree with no gate file shows the one CNT002 on
  `BAgent.perm_check_rpcs`, which `chip_smoke.py`'s ingest gate reads, so
  with `chip_smoke.py` as its gate file the port's tree is clean.
* Two faults planted in a copy of the port's tree: both report the same two.
* The CLI's exit codes and baseline file match JAX's; `python -m
  repro_torch.core.analysis` prints file:line findings; its defaults lint
  the port's live tree clean against its empty baseline.
* Linting a fixture without a `wire.py` reads the port's slot table and
  loads nothing of `repro`.
"""
import _torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.analysis import buffetlint as jax_lint
from repro_torch.core.analysis import buffetlint as port_lint

ROOT = Path(__file__).resolve().parents[1]
PORT_CORE = ROOT / "src" / "repro_torch" / "core"
JAX_CORE = ROOT / "src" / "repro" / "core"
GATE = ROOT / "chip_smoke.py"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _write(root, files):
    root.mkdir(parents=True, exist_ok=True)
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return root


def _rows(findings):
    return [(f.rule, f.path, f.line, f.symbol, f.message, f.hint, f.detail, f.fingerprint)
            for f in findings]


def _both(paths, bench=()):
    """Both lints' findings on the same tree, held equal; the port's."""
    port = port_lint.lint_paths(paths, bench)
    assert _rows(port) == _rows(jax_lint.lint_paths(paths, bench))
    return port


# ---------------------------------------------------------------------------
# rule fixtures: the sources of tests/test_buffetlint.py, one case each
# ---------------------------------------------------------------------------

FIXTURE_WIRE = """
from enum import IntEnum

class MsgType(IntEnum):
    ALPHA = 1
    BETA = 2
    GAMMA = 3

_SLOT_DEFS = (
    ("offset", "Q"),
    ("length", "Q"),
)
"""

# name: (files, gate files, the rules found, in the lint's order)
FIXTURES = {
    "lock001_rpc_under_server_lock": ({"bserver.py": """
class BServer:
    def bad(self, addr, msg):
        with self._lock:
            return self.transport.request(addr, msg)
"""}, None, ["LOCK001"]),
    "lock001_snapshot_then_release_is_clean": ({"bserver.py": """
class BServer:
    def good(self, addr, msg):
        with self._lock:
            watchers = dict(self._watchers)
        for w in watchers:
            self.transport.request(addr, msg)
"""}, None, []),
    "lock001_transitive_through_helper": ({"bserver.py": """
class BServer:
    def outer(self):
        with self._lock:
            self._helper()

    def _helper(self):
        self.transport.request(self.addr, self.msg)
"""}, None, ["LOCK001"]),
    "lock001_per_file_lock_fanout_is_allowed": ({"bserver.py": """
class BServer:
    def fanout(self, fid, addr, msg):
        with self._file_lock(fid):
            self.transport.request(addr, msg)
"""}, None, []),
    "lock001_known_fanout_helper_blocks": ({"bserver.py": """
class BServer:
    def bad(self, fid):
        with self._groups_mutex:
            self.server._repl_send(1, None)
"""}, None, ["LOCK001"]),
    "lock002_direct_inversion": ({"bserver.py": """
class BServer:
    def bad(self, home, fid, idx):
        with self._chunk_lock(home, fid, idx):
            with self._file_lock(fid):
                pass
"""}, None, ["LOCK002"]),
    "lock002_declared_order_is_clean": ({"bserver.py": """
class BServer:
    def good(self, parent, fid, home, idx):
        with self._dir_mutex(parent):
            with self._file_lock(fid):
                with self._chunk_lock(home, fid, idx):
                    with self._lock:
                        pass
"""}, None, []),
    "lock002_reentrant_same_class_is_clean": ({"bserver.py": """
class BServer:
    def reenter(self):
        with self._lock:
            with self._lock:
                pass
"""}, None, []),
    "lock002_transitive_through_call": ({"bserver.py": """
class BServer:
    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._dir_mutex(1):
            pass
"""}, None, ["LOCK002"]),
    "suppression_with_reason_silences": ({"bserver.py": """
class BServer:
    def deliberate(self, addr, msg):
        with self._lock:
            # buffetlint: ignore[LOCK001] fan-out must hold the lock here
            # because this fixture says so
            return self.transport.request(addr, msg)
"""}, None, []),
    "suppression_without_reason_is_meta_finding": ({"bserver.py": """
class BServer:
    def deliberate(self, addr, msg):
        with self._lock:
            # buffetlint: ignore[LOCK001]
            return self.transport.request(addr, msg)
"""}, None, ["META001"]),
    "suppression_for_other_rule_does_not_silence": ({"bserver.py": """
class BServer:
    def deliberate(self, addr, msg):
        with self._lock:
            # buffetlint: ignore[WIRE006] wrong rule id
            return self.transport.request(addr, msg)
"""}, None, ["LOCK001"]),
    "wire005_duplicate_verb_number": ({"wire.py": """
from enum import IntEnum

class MsgType(IntEnum):
    ALPHA = 1
    BETA = 1

_SLOT_DEFS = (("offset", "Q"),)
"""}, None, ["WIRE005"]),
    "wire001_002_handler_coverage": ({"wire.py": FIXTURE_WIRE, "bserver.py": """
class BServer:
    @SERVER_OPS.register(MsgType.ALPHA)
    def _op_alpha(self, h, p):
        return ok()

    @SERVER_OPS.register(MsgType.ALPHA)
    def _op_alpha_again(self, h, p):
        return ok()

    @SERVER_OPS.register(MsgType.BETA)
    def _op_beta(self, h, p):
        return ok()
"""}, None, ["WIRE001", "WIRE002"]),
    "wire003_missing_breaks_lease": ({"wire.py": FIXTURE_WIRE, "bserver.py": """
class BServer:
    @SERVER_OPS.register(MsgType.ALPHA, mutating=True)
    def _op_alpha(self, h, p):
        self._revoke_leases(h["file_id"])
        return ok()

    @SERVER_OPS.register(MsgType.BETA, mutating=True, breaks_lease=True)
    def _op_beta(self, h, p):
        self._revoke_leases(h["file_id"])
        return ok()

    @SERVER_OPS.register(MsgType.GAMMA, mutating=True, breaks_lease=True)
    def _op_gamma(self, h, p):
        return ok()
"""}, None, ["WIRE003", "WIRE003"]),
    "wire003_journal_requires_mutating": ({"wire.py": FIXTURE_WIRE, "bserver.py": """
class BServer:
    @SERVER_OPS.register(MsgType.ALPHA)
    def _op_alpha(self, h, p):
        self._journal({"op": "x"})
        return ok()

    @SERVER_OPS.register(MsgType.BETA, mutating=True)
    def _op_beta(self, h, p):
        self._journal({"op": "x"})
        return ok()

    @SERVER_OPS.register(MsgType.GAMMA)
    def _op_gamma(self, h, p):
        return ok()
"""}, None, ["WIRE003"]),
    "wire003_closure_reachability": ({"wire.py": FIXTURE_WIRE, "bserver.py": """
class BServer:
    @SERVER_OPS.register(MsgType.ALPHA)
    def _op_alpha(self, h, p):
        def apply():
            self._journal({"op": "x"})
        return self._two_phase(h["parent"], [h["name"]], apply)
"""}, None, ["WIRE001", "WIRE001", "WIRE003"]),
    "wire004_barrier_without_durability": ({"wire.py": FIXTURE_WIRE, "bserver.py": """
import os

class BServer:
    @SERVER_OPS.register(MsgType.ALPHA, barrier=True)
    def _op_alpha(self, h, p):
        return ok()

    @SERVER_OPS.register(MsgType.BETA, barrier=True)
    def _op_beta(self, h, p):
        self._persist_now()
        return ok()

    @SERVER_OPS.register(MsgType.GAMMA, barrier=True)
    def _op_gamma(self, h, p):
        with open("f", "rb") as f:
            os.fsync(f.fileno())
        return ok()
"""}, None, ["WIRE004"]),
    "wire006_unregistered_header_key": ({"bserver.py": """
class BServer:
    def encode(self, t):
        h = {"offset": 1, "shiny_new_field": 2}
        return Message(t, h)

    def encode2(self):
        return ok({"another_rogue": 1})

    def patch(self, resp):
        resp.header["third_rogue"] = 1
"""}, None, ["WIRE006", "WIRE006", "WIRE006"]),
    "wire006_slots_and_ext_allowed_are_clean": ({"bserver.py": """
class BServer:
    def encode(self, t):
        return Message(t, {"offset": 1, "epoch": 2, "msg": "cold"})
"""}, None, []),
    "cnt001_surfaced_never_set": ({"bserver.py": """
class BServer:
    def __init__(self):
        self.ghost_counter = 0
""", "blib.py": """
class BLib:
    def io_stats(self):
        return {"ghost": self.agent.ghost_counter}
"""}, None, ["CNT001"]),
    "cnt002_incremented_never_surfaced": ({"bserver.py": """
class BServer:
    def __init__(self):
        self.orphan_counter = 0

    def tick(self):
        self.orphan_counter += 1
"""}, None, ["CNT002"]),
    "cnt002_direct_gate_read_counts_as_surfaced": ({"bserver.py": """
class BServer:
    def __init__(self):
        self.probed = 0

    def tick(self):
        self.probed += 1

def gate(srv):
    return srv.probed
"""}, None, []),
    "cnt003_benchmark_names_missing_counter": ({"bserver.py": """
class BServer:
    def __init__(self):
        self.real_counter = 0
"""}, {"fig99.py": """
def check(cluster):
    a = _sum_srv(cluster, "real_counter")
    b = _sum_srv(cluster, "imaginary_counter")
    return a + b
"""}, ["CNT003"]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_fixture_gives_jax_findings(tmp_path, name):
    files, bench, rules = FIXTURES[name]
    root = _write(tmp_path / "fixture", files)
    bench_paths = [_write(tmp_path / "bench", bench)] if bench else []
    found = _both([root], bench_paths)
    assert [f.rule for f in found] == rules


def test_rule_fixtures_name_what_jax_tests_name(tmp_path):
    """The anchors `tests/test_buffetlint.py` asserts, on the port's lint."""
    def lint(name):
        files, bench, _ = FIXTURES[name]
        root = _write(tmp_path / name, files)
        return port_lint.lint_paths(
            [root], [_write(tmp_path / (name + "_bench"), bench)] if bench else [])
    [f] = lint("lock001_rpc_under_server_lock")
    assert f.symbol == "BServer.bad" and "server_lock" in f.message
    assert "via `BServer.inner`" in lint("lock002_transitive_through_call")[0].message
    gamma = next(f for f in lint("wire001_002_handler_coverage") if f.rule == "WIRE001")
    assert gamma.symbol == "GAMMA"
    assert {(f.symbol, f.detail) for f in lint("wire003_missing_breaks_lease")} == {
        ("ALPHA", "breaks_lease-missing"), ("GAMMA", "breaks_lease-stale")}
    assert sorted(f.detail for f in lint("wire006_unregistered_header_key")) == [
        "another_rogue", "shiny_new_field", "third_rogue"]
    assert lint("cnt003_benchmark_names_missing_counter")[0].detail == "imaginary_counter"


def test_finding_fingerprint_shape():
    args = ("LOCK001", "bserver.py", 12, "BServer.bad", "m", "h")
    f = port_lint.Finding(*args, detail="request@server_lock")
    j = jax_lint.Finding(*args, detail="request@server_lock")
    assert f.fingerprint == j.fingerprint == \
        "LOCK001:bserver.py:BServer.bad:request@server_lock"
    assert f.render() == j.render() and "bserver.py:12" in f.render()


def test_catalogs_are_jax_catalogs():
    for name in ("RULES", "LOCK_RANK", "SERVER_SCOPE", "BLOCKING_CALL_ATTRS",
                 "BLOCKING_HELPER_NAMES", "DURABILITY_NAMES", "MUTATION_NOTE_NAMES",
                 "UNHANDLED_VERBS", "EXT_ALLOWED", "SURFACE_FUNCS", "COUNTER_CLASSES"):
        assert getattr(port_lint, name) == getattr(jax_lint, name), name
    assert [vars(c) for c in port_lint.LOCK_REGISTRY] == \
        [vars(c) for c in jax_lint.LOCK_REGISTRY]
    assert port_lint._SUPPRESS_RE.pattern == jax_lint._SUPPRESS_RE.pattern


# ---------------------------------------------------------------------------
# live trees
# ---------------------------------------------------------------------------

PERM_CNT002 = ("CNT002", "bagent.py", "BAgent", "BAgent.perm_check_rpcs")


def test_jax_tree_with_its_benchmarks_is_clean_for_both():
    assert _both([JAX_CORE], [ROOT / "benchmarks"]) == []


def test_port_tree_without_gate_files_shows_perm_check_rpcs_for_both():
    [f] = _both([PORT_CORE])
    assert (f.rule, f.path, f.symbol, f.detail) == PERM_CNT002
    assert "incremented but never surfaced" in f.message


def test_port_tree_with_chip_smoke_as_gate_is_clean_for_both():
    assert _both([PORT_CORE], [GATE]) == []


def test_port_tree_clean_against_its_empty_baseline():
    baseline = PORT_CORE / "analysis" / "baseline.json"
    assert json.loads(baseline.read_text())["allow"] == []
    assert port_lint.main([str(PORT_CORE), "--check", "--baseline", str(baseline),
                           "--benchmarks", str(GATE)]) == 0
    assert port_lint.main(["--check"]) == 0      # the defaults: the same three paths


def _pragmas(core):
    return sorted((p.name, m.group(1).strip(), m.group(2).strip())
                  for p in core.rglob("*.py") if "analysis" not in p.parts
                  for m in map(port_lint._SUPPRESS_RE.search, p.read_text().splitlines())
                  if m)


def test_port_tree_suppressions_are_jax_ones_each_with_a_reason():
    pragmas = _pragmas(PORT_CORE)
    assert [(f, r) for f, r, _ in pragmas] == [("blib.py", "CNT001"), ("bserver.py", "LOCK001")]
    assert pragmas == _pragmas(JAX_CORE) and all(reason for *_, reason in pragmas)
    assert [f for f in port_lint.lint_paths([PORT_CORE]) if f.rule == "META001"] == []


# ---------------------------------------------------------------------------
# faults planted in a copy of the port's tree
# ---------------------------------------------------------------------------

def test_planted_faults_in_a_copy_of_the_port_tree_match(tmp_path):
    """A per-file lock taken under the server lock (LOCK002) and a counter
    incremented there and read nowhere (CNT002), in `bserver.py`."""
    core = tmp_path / "core"
    shutil.copytree(PORT_CORE, core, ignore=shutil.ignore_patterns("__pycache__"))
    path = core / "bserver.py"
    src = path.read_text()
    init = "        self._lock = threading.RLock()\n"
    assert src.count(init) == 1
    src = src.replace(init, init + "        self.planted_orphan = 0\n")
    lines = src.splitlines(keepends=True)
    i = next(i for i, ln in enumerate(lines) if ln.strip() == "with self._lock:")
    pad = " " * (len(lines[i]) - len(lines[i].lstrip()) + 4)
    lines[i + 1:i + 1] = [f"{pad}with self._file_lock(0):\n",
                          f"{pad}    self.planted_orphan += 1\n"]
    path.write_text("".join(lines))
    found = _both([core], [GATE])
    assert sorted(f.fingerprint for f in found) == [
        "CNT002:bserver.py:BServer:BServer.planted_orphan",
        f"LOCK002:bserver.py:{found[0].symbol}:file_lock<server_lock"]
    assert found[0].rule == "LOCK002" and found[0].line == i + 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SEEDED = """
class BServer:
    def bad(self, addr, msg):
        with self._lock:
            return self.transport.request(addr, msg)
"""


def test_check_and_update_baseline_exit_codes_match_jax(tmp_path):
    """--check fails on a new finding, --update-baseline grandfathers it,
    a line shift keeps it grandfathered, a second violation is new: the
    same exit codes from both CLIs, and the same allow-list."""
    codes, allow = {}, {}
    for name, lint in (("jax", jax_lint), ("port", port_lint)):
        root = _write(tmp_path / name / "tree", {"bserver.py": SEEDED})
        bench = _write(tmp_path / name / "nobench", {})
        bl = tmp_path / name / "baseline.json"
        args = [str(root), "--baseline", str(bl), "--benchmarks", str(bench)]
        got = [lint.main(["--check"] + args), lint.main(["--update-baseline"] + args),
               lint.main(["--check"] + args)]
        allow[name] = json.loads(bl.read_text())["allow"]
        (root / "bserver.py").write_text("# a comment\n# another\n" + SEEDED)
        got.append(lint.main(["--check"] + args))
        (root / "bserver.py").write_text(SEEDED + """
    def bad2(self, addr, msg):
        with self._groups_mutex:
            return self.transport.request(addr, msg)
""")
        got += [lint.main(["--check"] + args), lint.main(args)]
        codes[name] = got
    assert codes["port"] == codes["jax"] == [1, 0, 0, 0, 1, 1]
    assert allow["port"] == allow["jax"] and [a["rule"] for a in allow["port"]] == ["LOCK001"]


def test_cli_module_seeded_violation_exits_nonzero(tmp_path):
    root = _write(tmp_path / "tree", {"bserver.py": SEEDED, "counters.py": """
class BServer:
    def __init__(self):
        self.never_read = 0

    def tick(self):
        self.never_read += 1
"""})
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.analysis", "--check", str(root),
         "--baseline", str(tmp_path / "absent.json"),
         "--benchmarks", str(tmp_path / "nobench")],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=120)
    assert proc.returncode == 1
    assert "LOCK001" in proc.stdout and "CNT002" in proc.stdout
    assert re.search(r"bserver\.py:\d+: LOCK001", proc.stdout)


def test_cli_module_defaults_lint_the_port_tree_clean_from_anywhere(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.core.analysis", "--check"],
                          capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "buffetlint: clean (0 grandfathered, 0 baselined)" in proc.stdout


def test_fixture_without_wire_reads_the_port_slot_table_and_loads_no_repro(tmp_path):
    root = _write(tmp_path / "tree", {"bserver.py": """
class BServer:
    def encode(self, t):
        return Message(t, {"offset": 1, "not_a_slot": 2})
"""})
    code = ("import json, sys\n"
            "from repro_torch.core.analysis import buffetlint as b\n"
            f"found = b.lint_paths([__import__('pathlib').Path({str(root)!r})])\n"
            "print(json.dumps([[f.rule, f.detail] for f in found]))\n"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('repro', 'jax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, check=True)
    found, loaded = map(json.loads, out.stdout.strip().splitlines()[-2:])
    assert found == [["WIRE006", "not_a_slot"]] and loaded == []
    assert port_lint.WIRE_PY == PORT_CORE / "wire.py"

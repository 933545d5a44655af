"""Runtime lock-order recorder — the dynamic cross-check for buffetlint.

buffetlint's LOCK002 pass derives "who may nest inside whom" statically
from `LOCK_REGISTRY`.  This module answers the converse question at test
time: which nestings actually HAPPEN under real workloads?  One test
(`tests/test_torch_core_lockrec.py`) instruments every lock class on the
servers of a live cluster of the port's BuffetFS, drives striping and
permission traffic, and asserts that no observed acquisition pair
inverts the declared order — so the registry can never drift into
documenting an order the code stopped following.  `chip_smoke.py`'s
train_resume records the Trainer's own clusters the same way.

Debug-only by design: `instrument_server` monkey-patches one BServer
instance's lock attributes and lock-factory methods with recording
proxies.  Production code never imports this module.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple

from .buffetlint import LOCK_RANK


class _RecordingLock:
    """Context-manager proxy over a real lock that reports transitions."""

    __slots__ = ("_lock", "_cls", "_rec")

    def __init__(self, lock, cls: str, rec: "LockOrderRecorder") -> None:
        self._lock = lock
        self._cls = cls
        self._rec = rec

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self._rec._note_acquire(self._cls)
        return got

    def release(self) -> None:
        self._rec._note_release(self._cls)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LockOrderRecorder:
    """Collects (held_class -> acquired_class) pairs across all threads."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._mu = threading.Lock()
        self.pairs: Set[Tuple[str, str]] = set()

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _note_acquire(self, cls: str) -> None:
        st = self._stack()
        held = set(st)
        if held:
            with self._mu:
                for h in held:
                    self.pairs.add((h, cls))
        st.append(cls)

    def _note_release(self, cls: str) -> None:
        st = self._stack()
        # release order can interleave for distinct entities of one
        # class: drop the innermost matching entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] == cls:
                del st[i]
                return

    # -- instrumentation ------------------------------------------------

    def instrument_server(self, srv) -> None:
        """Wrap one BServer's registered lock classes in recording
        proxies: the bare locks (`_lock`, `_groups_mutex`) are replaced
        in place, the per-entity factories (`_file_lock`, `_dir_mutex`,
        `_chunk_lock`) are wrapped so every lock they hand out records
        under its class name."""
        srv._lock = _RecordingLock(srv._lock, "server_lock", self)
        srv._groups_mutex = _RecordingLock(
            srv._groups_mutex, "groups_mutex", self)

        def wrap_factory(method, cls: str):
            def factory(*args):
                return _RecordingLock(method(*args), cls, self)
            return factory

        srv._file_lock = wrap_factory(srv._file_lock, "file_lock")
        srv._dir_mutex = wrap_factory(srv._dir_mutex, "dir_mutex")
        srv._chunk_lock = wrap_factory(srv._chunk_lock, "chunk_lock")

    # -- verdicts -------------------------------------------------------

    def violations(self,
                   ranks: Dict[str, int] = LOCK_RANK
                   ) -> List[Tuple[str, str]]:
        """Observed pairs that invert the declared order.  Same-class
        nesting is legal (the server lock is an RLock; per-entity locks
        only nest on distinct entities), matching LOCK002's rule."""
        return sorted(
            (held, acquired) for held, acquired in self.pairs
            if held != acquired and ranks[acquired] <= ranks[held])

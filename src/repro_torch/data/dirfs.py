"""DirLib — the storage client calls of the port's data and checkpoint
code, on a local directory.

The port's `BuffetDataset`, `DataPipeline` and `CheckpointManager` talk to
a client object the caller passes in: a `repro_torch.core.BLib` over a
BuffetFS cluster (what the Trainer builds itself when it is given none),
or this stand-in on a local directory.  It offers the calls those modules
make on a `BLib`, and no others: `makedirs`, `write_file`, `read_file`,
`listdir`, `exists`, `unlink`, `walk_files`, and `agent.warm(dir)`.  A path `/a/b` is
`<root>/a/b`.  Its warm does nothing and it counts no RPCs: `agent.stats`
is None, so the Trainer reports no RPC counts for it.  A file is written
to a temporary name and renamed, so a reader never sees half of one.
"""
from __future__ import annotations

import os
import threading
from typing import Iterator, List


class _DirAgent:
    """What the data path asks of a BAgent: `warm` (nothing to cache on a
    local directory) and `stats` (None: no RPCs to count)."""
    stats = None

    def warm(self, path: str) -> None:
        pass


class DirLib:
    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.agent = _DirAgent()

    def _path(self, path: str) -> str:
        parts = [p for p in path.split("/") if p]
        if any(p in (".", "..") for p in parts):
            raise ValueError(f"DirLib paths name no '.' or '..': {path!r}")
        return os.path.join(self.root, *parts)

    def makedirs(self, path: str) -> None:
        os.makedirs(self._path(path), exist_ok=True)

    def write_file(self, path: str, data: bytes) -> int:
        dst = self._path(path)
        tmp = f"{dst}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dst)
        return len(data)

    def read_file(self, path: str) -> bytes:
        with open(self._path(path), "rb") as f:
            return f.read()

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(self._path(path)))

    def exists(self, path: str) -> bool:
        return os.path.exists(self._path(path))

    def unlink(self, path: str) -> None:
        os.unlink(self._path(path))

    def walk_files(self, path: str) -> Iterator[str]:
        for name in self.listdir(path):
            child = path.rstrip("/") + "/" + name
            if os.path.isdir(self._path(child)):
                yield from self.walk_files(child)
            else:
                yield child

"""Checkpointing over BuffetFS: sharded, async, atomic, elastic — the
port's copy of `repro/ckpt/manager.py`, writing what JAX writes.

Layout per step:

    /ckpt/<run>/step_00000100/part_000/<leaf-path>.npy   (many smallish files)
    /ckpt/<run>/step_00000100/MANIFEST                   (written LAST)

* **Atomic commit** — readers only trust steps whose MANIFEST exists and
  whose checksums verify; MANIFEST is written after every shard file, so a
  crashed save is simply invisible (no torn checkpoints).
* **Async save** — `save(..., block=False)` copies every leaf to host
  memory before it returns and writes on a background thread.  The copy
  must finish first: the port's AdamW writes params and moments in place
  (`optim/adamw.py`), so the next step would change a leaf still being
  read.
* **Elastic restore** — arrays are split over `parts` along axis 0 at save
  time; restore reassembles them from the manifest, whatever `parts` the
  reading manager has.
* **Fault tolerance** — shard files carry crc32s recorded in the manifest;
  `restore` verifies them, and `latest_step` skips uncommitted steps.

Leaves are named and laid out as the JAX package's: the port keeps one dict
per layer (`params["blocks"][i]`), JAX one `[L, ...]` array per leaf, so
every list under a `blocks` key is written stacked (as
`convert.to_jax_params` stacks it: `params.blocks.in_proj`,
`opt.m.blocks.in_proj`; a hybrid model's `params.blocks.layers.0.mixer...`
over its period blocks), and unstacked on restore; `prefix.0...` and
`opt.step` are as they are.  One leaf is stacked on the host at a time.  A
bf16 leaf is written as its bits in a 2-byte void array (`.npy` descr
`|V2`, manifest dtype "bfloat16"), which JAX's restore views as bfloat16;
a void part is read back (JAX writes `<V2`) through an `int16` view into
`torch.bfloat16`.  Nothing here needs `ml_dtypes`.  `lib` is the storage
client the caller passes in (a `repro.core.BLib`, or `data.dirfs.DirLib`).
"""
from __future__ import annotations

import io
import json
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_map

BF16 = "bfloat16"


class _Stack(list):
    """The per-block tensors of one leaf, which JAX holds stacked on axis 0."""


def _jax_layout(tree: Any) -> Any:
    """`tree` with every list under a `blocks` key turned into one `_Stack`
    a leaf (no `blocks` where the list is empty, as `to_jax_params`)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "blocks" and isinstance(v, list):
                if v:
                    out[k] = tree_map(lambda *ts: _Stack(ts), *v)
            else:
                out[k] = _jax_layout(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [_jax_layout(v) for v in tree]
    return tree


def _leaf_name(keys: List[Any]) -> str:
    """JAX's `_leaf_name` of the key path: keys joined by '.'."""
    s = "".join(f".{k}" for k in keys)
    return s.replace("/", "_").replace("'", "").replace("[", ".").replace("]", "") \
            .replace(" ", "").strip(".")


def _flatten(tree: Any, keys: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in `jax.tree_util`'s order: dict keys sorted, list
    items in order; a `_Stack` is one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], keys + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, _Stack):
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + (i,))
    else:
        yield _leaf_name(list(keys)), tree


def _host_copy(leaf: Any) -> torch.Tensor:
    """A leaf (a tensor, or a `_Stack` of tensors) copied to a new CPU
    tensor, stacked on axis 0 for a `_Stack`; the copy has finished when
    this returns."""
    if isinstance(leaf, _Stack):
        out = torch.empty((len(leaf), *leaf[0].shape), dtype=leaf[0].dtype)
        for i, t in enumerate(leaf):
            out[i].copy_(t.detach())
        return out
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A CPU tensor as the numpy array written to disk and its manifest
    dtype: bf16 as its bits in a 2-byte void array."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2")), BF16
    a = t.contiguous().numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A part read from disk as a CPU tensor of the manifest's dtype."""
    if a.dtype.kind == "V":
        if dtype != BF16 or a.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {a.dtype} part as {dtype}")
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)).view(torch.bfloat16)
    if dtype == BF16:
        raise ValueError(f"a bfloat16 leaf's part holds {a.dtype}, not its bits")
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype), order="C"))


@dataclass
class Manifest:
    step: int
    parts: int
    leaves: List[Dict[str, Any]]  # {name, shape, dtype, files: [{path, crc}]}
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return json.dumps({"step": self.step, "parts": self.parts,
                           "leaves": self.leaves, "extra": self.extra}).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "Manifest":
        d = json.loads(b.decode())
        return Manifest(**d)


class CheckpointManager:
    def __init__(self, lib: Any, run: str = "run0", *, base: str = "/ckpt",
                 parts: int = 4, keep_last: int = 3) -> None:
        self.lib = lib
        self.base = f"{base}/{run}"
        self.parts = parts
        self.keep_last = keep_last
        self.lib.makedirs(self.base)
        self._inflight: Optional[threading.Thread] = None
        self._save_lock = threading.Lock()
        # one record a save: step, wait_s (for the previous async write),
        # snapshot_s (the copy to host: what blocks the caller), write_s
        # (the file writes), leaves, bytes and files written
        self.saves: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}"

    @staticmethod
    def _np_bytes(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        return buf.getvalue()

    def _write_leaf(self, sdir: str, name: str, t: torch.Tensor, rec: Dict[str, Any]
                    ) -> Dict[str, Any]:
        arr, dtype = _to_numpy(t)
        nparts = self.parts if (arr.ndim > 0 and arr.shape[0] >= self.parts) else 1
        chunks = np.array_split(arr, nparts, axis=0) if nparts > 1 else [arr]
        files = []
        for pi, chunk in enumerate(chunks):
            pdir = f"{sdir}/part_{pi:03d}"
            self.lib.makedirs(pdir)
            path = f"{pdir}/{name}.npy"
            blob = self._np_bytes(chunk)
            self.lib.write_file(path, blob)
            files.append({"path": path, "crc": zlib.crc32(blob)})
            rec["bytes"] += len(blob)
            rec["files"] += 1
        return {"name": name, "shape": list(arr.shape), "dtype": dtype, "files": files}

    def _write_tree(self, step: int, leaves: Iterator[Tuple[str, torch.Tensor]],
                    extra: Dict[str, Any], rec: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        sdir = self._step_dir(step)
        self.lib.makedirs(sdir)
        leaves_meta = [self._write_leaf(sdir, name, t, rec) for name, t in leaves]
        rec["leaves"] = len(leaves_meta)
        man = Manifest(step=step, parts=self.parts, leaves=leaves_meta, extra=extra)
        blob = man.to_bytes()
        self.lib.write_file(f"{sdir}/MANIFEST", blob)
        rec["bytes"] += len(blob)
        rec["files"] += 1
        self._gc()
        rec["write_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[Dict[str, Any]] = None,
             block: bool = True) -> None:
        """Write `tree` (nested dicts and lists of tensors, the port's
        layout) as step `step`.  With `block=False` every leaf is copied to
        the host before this returns, and the files are written on a thread
        (`wait` joins it); the previous async save is waited for first, so
        one copy of the state is held on the host at a time."""
        extra = extra or {}
        rec = {"step": step, "block": block, "bytes": 0, "files": 0}
        self.saves.append(rec)
        flat = list(_flatten(_jax_layout(tree)))
        if block:
            # one leaf stacked on the host at a time
            rec["wait_s"] = rec["snapshot_s"] = 0.0
            with self._save_lock:
                self._write_tree(step, ((n, _host_copy(x)) for n, x in flat), extra, rec)
            return
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        snap = [(n, _host_copy(x)) for n, x in flat]
        rec["wait_s"], rec["snapshot_s"] = t1 - t0, time.perf_counter() - t1
        self._inflight = threading.Thread(
            target=lambda: self._write_tree(step, iter(snap), extra, rec), daemon=True)
        self._inflight.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        try:
            names = self.lib.listdir(self.base)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("step_"):
                sdir = f"{self.base}/{n}"
                if self.lib.exists(f"{sdir}/MANIFEST"):
                    out.append(int(n[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: int) -> Manifest:
        return Manifest.from_bytes(self.lib.read_file(f"{self._step_dir(step)}/MANIFEST"))

    def _read_leaf(self, lm: Dict[str, Any]) -> torch.Tensor:
        parts = []
        for f in lm["files"]:
            blob = self.lib.read_file(f["path"])
            if zlib.crc32(blob) != f["crc"]:
                raise IOError(f"checksum mismatch in {f['path']}")
            parts.append(_from_numpy(np.load(io.BytesIO(blob), allow_pickle=False),
                                     lm["dtype"]))
        t = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        return t.reshape(lm["shape"])

    def restore(self, step: Optional[int] = None, *, like: Any = None
                ) -> Tuple[int, Any]:
        """Reassemble the checkpoint (elastically: any `parts`).

        Without `like`, a dict of CPU tensors by leaf name (the JAX layout).
        With `like` (the port's layout), a tree of its structure: each leaf
        checked against the shape of `like`'s (stacked, for the blocks),
        cast to its dtype, put on its device, with its `requires_grad`;
        read one checkpoint leaf at a time."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no committed checkpoint")
        man = self.manifest(step)
        by_name = {lm["name"]: lm for lm in man.leaves}
        if like is None:
            return step, {name: self._read_leaf(lm) for name, lm in by_name.items()}
        restored: Dict[int, torch.Tensor] = {}
        for name, want in _flatten(_jax_layout(like)):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = self._read_leaf(by_name[name])
            dsts = want if isinstance(want, _Stack) else [want]
            shape = (len(dsts), *dsts[0].shape) if isinstance(want, _Stack) else tuple(want.shape)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: ckpt shape {tuple(t.shape)} != {tuple(shape)}")
            for i, dst in enumerate(dsts):
                src = t[i] if isinstance(want, _Stack) else t
                restored[id(dst)] = src.to(device=dst.device, dtype=dst.dtype,
                                           copy=True).requires_grad_(dst.requires_grad)
        return step, tree_map(lambda x: restored[id(x)], like)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            sdir = self._step_dir(s)
            try:
                # delete manifest first => step becomes invisible atomically
                self.lib.unlink(f"{sdir}/MANIFEST")
                for f in list(self.lib.walk_files(sdir)):
                    self.lib.unlink(f)
            except OSError:
                pass

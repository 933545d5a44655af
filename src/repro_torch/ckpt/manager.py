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
* **Sharded save** — a tree with DTensor leaves (`runtime/steps.py::
  shard_train_state`'s) is written as JAX's `np.array(x)` writes a sharded
  `jax.Array`: whole, in the same files.  Each DTensor leaf is gathered
  whole, one leaf (one block of a stack) at a time, by `full_tensor()`, in
  `_flatten`'s order on every rank of the leaves' mesh (a collective); rank
  0 of the mesh copies it to its host and writes every file, plain leaves
  (`opt.step`) included, and the other ranks free it and write nothing.
  So a device holds at most one gathered leaf beyond its own shards, and
  the files are byte for byte a plain save's of the same values.  The
  gathers finish on every rank before `save` returns; the writer thread
  issues no collective.  `wait` (and the end of a blocking save) meets on
  every rank: rank 0 joins its writer, then all ranks reduce a flag over
  the mesh from the main thread, so that every rank sees the step
  committed, or every rank raises.
* **Elastic restore** — arrays are split over `parts` along axis 0 at save
  time; restore reassembles them from the manifest, whatever `parts` the
  reading manager has.  A leaf of `like` that is a DTensor (or a `Placed`,
  `runtime/elastic.py`'s description of one) comes back as a DTensor at
  its placements: each rank reads the leaf's parts one at a time, checks
  their crc32s and shapes, and copies only its own shard to the device, cut
  as `runtime/sharding.py::distribute` cuts it.  No collective, no whole
  leaf on a device, at most the shard and one part file on the host.
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
client the caller passes in (a `repro_torch.core.BLib`, or `data.dirfs.DirLib`).
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _blocks(leaf: Any) -> list:
    return list(leaf) if isinstance(leaf, _Stack) else [leaf]


def _mesh_of(flat: List[Tuple[str, Any]]) -> Any:
    """The `DeviceMesh` of the tree's DTensor leaves (None where it has
    none); they must all lie on one."""
    mesh = None
    for name, leaf in flat:
        for t in _blocks(leaf):
            if isinstance(t, DTensor):
                if mesh is not None and t.device_mesh != mesh:
                    raise ValueError(f"{name}: the DTensor leaves lie on more than one mesh")
                mesh = t.device_mesh
    return mesh


def _host_copy(leaf: Any, rec: Dict[str, Any], writer: bool = True) -> Optional[torch.Tensor]:
    """A leaf (a tensor, a DTensor, or a `_Stack` of them) copied to a new
    CPU tensor, stacked on axis 0 for a `_Stack`, on the writer; None on
    another rank.  A DTensor is gathered whole first (`full_tensor()`, a
    collective every rank of its mesh makes), one block at a time, and
    freed after its copy.  The copy has finished when this returns; `rec`
    counts the gathers' and copies' seconds and the bytes gathered."""
    stacked, out = isinstance(leaf, _Stack), None
    for i, t in enumerate(_blocks(leaf)):
        if isinstance(t, DTensor):
            t0 = time.perf_counter()
            t = t.detach().full_tensor()
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            rec["gather_s"] += time.perf_counter() - t0
            rec["gathered_bytes"] += t.numel() * t.element_size()
        if not writer:
            continue
        t0 = time.perf_counter()
        t = torch.as_tensor(t).detach()
        if not stacked:
            out = t.to("cpu", copy=True)
        else:
            if out is None:
                out = torch.empty((len(leaf), *t.shape), dtype=t.dtype)
            out[i].copy_(t)
        rec["copy_s"] += time.perf_counter() - t0
    return out


def _commit(mesh: Any, ok: bool) -> None:
    """Every rank of `mesh` meets here, from the main thread: a flag reduced
    (min) over each mesh dim's group in turn, which orders every rank after
    rank 0's arrival; raises on every rank where any rank's write failed."""
    flag = torch.tensor([int(ok)], device=mesh.device_type)
    for i in range(mesh.ndim):
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.get_group(i))
    if not int(flag.item()):
        raise IOError("the sharded save's writer failed: the step is not committed")


def _local_ranges(shape: Tuple[int, ...], mesh: Any, pl: Tuple[Any, ...]
                  ) -> List[Tuple[int, int]]:
    """[start, stop) of this rank's shard on each dim of a tensor of
    `shape` at placements `pl` on `mesh`: torch.chunk along each `Shard`'s
    dim, mesh dim by mesh dim, as `runtime/sharding.py::distribute` cuts
    it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the leaf's mesh")
    rng = [(0, n) for n in shape]
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            if mesh.size(i) > 1:
                a, b = rng[p.dim]
                size = -(-(b - a) // mesh.size(i))
                lo = min(a + coord[i] * size, b)
                rng[p.dim] = (lo, min(lo + size, b))
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot restore a leaf at placement {p}")
    return rng


def _narrow(t: torch.Tensor, rng: List[Tuple[int, int]], first: int = 0) -> torch.Tensor:
    for d, (a, b) in enumerate(rng):
        t = t.narrow(first + d, a, b - a)
    return t


@dataclass(frozen=True)
class Placed:
    """What `restore` needs of a leaf of `like`: its global shape, dtype,
    device and requires_grad, and the mesh and placements of a DTensor
    (None: a plain tensor).  `of` reads it from a tensor, a DTensor or a
    fake tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool = False
    mesh: Any = None
    placements: Tuple[Any, ...] = ()

    @staticmethod
    def of(t: Any) -> "Placed":
        if isinstance(t, Placed):
            return t
        mesh, pl = (t.device_mesh, tuple(t.placements)) if isinstance(t, DTensor) else (None, ())
        return Placed(tuple(t.shape), t.dtype, t.device, t.requires_grad, mesh, pl)

    def same_layout(self, other: "Placed") -> bool:
        return ((self.mesh is None) == (other.mesh is None)
                and (self.mesh is None or self.mesh == other.mesh)
                and self.placements == other.placements)


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
        self._failed: Optional[BaseException] = None    # the writer thread's error
        self._uncommitted: Any = None     # the mesh of a sharded async save in flight
        self._save_lock = threading.Lock()
        # one record a save: step, wait_s (for the previous async write),
        # snapshot_s (the copy to host: what blocks the caller), of it
        # gather_s (a sharded save's gathers) and copy_s (the copies to the
        # host), gathered_bytes (the whole leaves gathered), write_s (the
        # file writes), leaves, bytes and files written (0 off the writer)
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
        one copy of the state is held on the host at a time.  A tree with
        DTensor leaves is gathered leaf by leaf onto rank 0 of their mesh,
        which writes it (every rank of the mesh calls `save`); see the
        module's docstring."""
        extra = extra or {}
        rec = {"step": step, "block": block, "bytes": 0, "files": 0, "gather_s": 0.0,
               "copy_s": 0.0, "gathered_bytes": 0}
        self.saves.append(rec)
        flat = list(_flatten(_jax_layout(tree)))
        mesh = _mesh_of(flat)
        writer = mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])
        if block:
            # one leaf stacked on the host at a time
            rec["wait_s"] = rec["snapshot_s"] = 0.0
            with self._save_lock:
                if writer:
                    self._write_tree(step, ((n, _host_copy(x, rec)) for n, x in flat), extra,
                                     rec)
                else:
                    for _, x in flat:
                        _host_copy(x, rec, writer=False)
            if mesh is not None:
                _commit(mesh, True)
            return
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        snap = [(n, _host_copy(x, rec, writer)) for n, x in flat]
        rec["wait_s"], rec["snapshot_s"] = t1 - t0, time.perf_counter() - t1
        self._uncommitted = mesh
        if writer:
            self._inflight = threading.Thread(
                target=self._write_async, args=(step, snap, extra, rec), daemon=True)
            self._inflight.start()

    def _write_async(self, step: int, snap: list, extra: Dict[str, Any],
                     rec: Dict[str, Any]) -> None:
        try:
            self._write_tree(step, iter(snap), extra, rec)
        except BaseException as e:     # raised by `wait`, on the caller's thread
            self._failed = e

    def wait(self) -> None:
        """Returns once the last async save is committed: its writer thread
        joined and, for a sharded save, every rank of the mesh met after it
        (`_commit`).  Raises where the write failed (on every rank of the
        mesh, for a sharded save)."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        failed, self._failed = self._failed, None
        mesh, self._uncommitted = self._uncommitted, None
        if mesh is not None:
            _commit(mesh, failed is None)
        if failed is not None:
            raise IOError("the async save's write failed") from failed

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

    def _parts(self, lm: Dict[str, Any]) -> Iterator[Tuple[int, torch.Tensor]]:
        """(first row on axis 0, part) of each part file of a leaf in turn,
        its crc32 and its shape checked against the manifest."""
        row, shape = 0, tuple(lm["shape"])
        for f in lm["files"]:
            blob = self.lib.read_file(f["path"])
            if zlib.crc32(blob) != f["crc"]:
                raise IOError(f"checksum mismatch in {f['path']}")
            part = _from_numpy(np.load(io.BytesIO(blob), allow_pickle=False), lm["dtype"])
            del blob
            if tuple(part.shape[1:]) != shape[1:] or (not shape and part.shape):
                raise ValueError(f"{f['path']}: part shape {tuple(part.shape)} in a leaf "
                                 f"of shape {shape}")
            yield row, part
            row += part.shape[0] if shape else 1
        if row != (shape[0] if shape else 1):
            raise ValueError(f"{lm['name']}: the parts hold {row} rows of {shape}")

    def _read_leaf(self, lm: Dict[str, Any]) -> torch.Tensor:
        parts = [p for _, p in self._parts(lm)]
        t = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
        return t.reshape(lm["shape"])

    def _read_placed(self, lm: Dict[str, Any], dsts: List[Placed], stacked: bool
                     ) -> List[torch.Tensor]:
        """The leaf `lm` read into `dsts` (one, or the blocks of a stack on
        axis 0), part by part: each gets the rows of its own shard (the
        whole leaf, where it is plain) copied into a new tensor on its
        device, cast to its dtype; a DTensor of its mesh and placements,
        with its requires_grad."""
        d0 = dsts[0]
        shape = tuple(d0.shape)
        rng = _local_ranges(shape, d0.mesh, d0.placements) if d0.mesh is not None else [
            (0, n) for n in shape]
        outs = [torch.empty([b - a for a, b in rng], dtype=d.dtype, device=d.device)
                for d in dsts]
        for row, part in self._parts(lm):
            if stacked:
                for j in range(part.shape[0]):
                    outs[row + j].copy_(_narrow(part[j], rng))
            elif not shape:
                outs[0].copy_(part)
            else:
                (a, b), n = rng[0], part.shape[0]
                lo, hi = max(a, row), min(b, row + n)
                if lo < hi:
                    outs[0][lo - a:hi - a].copy_(_narrow(part[lo - row:hi - row], rng[1:], 1))
        stride = torch.empty(shape, device="meta").stride()
        return [(o if d.mesh is None else DTensor.from_local(
                    o, d.mesh, d.placements, run_check=False, shape=torch.Size(shape),
                    stride=stride)).requires_grad_(d.requires_grad)
                for o, d in zip(outs, dsts)]

    def restore(self, step: Optional[int] = None, *, like: Any = None
                ) -> Tuple[int, Any]:
        """Reassemble the checkpoint (elastically: any `parts`).

        Without `like`, a dict of CPU tensors by leaf name (the JAX layout).
        With `like` (the port's layout), a tree of its structure: each leaf
        checked against the shape of `like`'s (stacked, for the blocks),
        cast to its dtype, put on its device, with its `requires_grad`; a
        DTensor leaf of `like` (or a `Placed` with a mesh) comes back as a
        DTensor at its placements, each rank holding only its own shard.
        `like` gives only shapes, dtypes, devices and placements: its leaves
        may be fake tensors.  Read one checkpoint leaf, one part file at a
        time; the blocks of a stack must share their placements."""
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
            stacked = isinstance(want, _Stack)
            dsts = [Placed.of(d) for d in _blocks(want)]
            if not all(d.same_layout(dsts[0]) for d in dsts):
                raise ValueError(f"{name}: the blocks of a stack differ in placements")
            shape = (len(dsts), *dsts[0].shape) if stacked else dsts[0].shape
            if tuple(by_name[name]["shape"]) != tuple(shape):
                raise ValueError(f"{name}: ckpt shape {tuple(by_name[name]['shape'])} != "
                                 f"{tuple(shape)}")
            for dst, t in zip(_blocks(want), self._read_placed(by_name[name], dsts, stacked)):
                restored[id(dst)] = t
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

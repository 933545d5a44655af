"""Per-device counts of a traced step: the counterpart of `repro/analysis/hlo.py`.

JAX's dry run compiles a cell and reads XLA's per-device cost analysis,
memory analysis and the collectives of its HLO.  The port has no HLO: it
runs the step itself, eagerly, on fake tensors (`FakeTensorMode`: shapes,
dtypes and a device, no memory and no launch) as one rank of the mesh, and
counts what that rank would do.  `StepTrace` is a `FakeTensorMode` that
counts, for every op on a rank's local tensors:

* FLOPs: `torch.utils.flop_counter`'s formula of each local op (products,
  convolutions, attention), plus the work each kernel wrapper records on its
  abstract path (`kernels/abstract.py`: the formulas of `chip_smoke.py`'s
  bounds, attention by causal pairs).  A DTensor op is not counted itself:
  its local op is, so a product whose output is split 4 ways counts a
  quarter, and work a rank repeats (a gathered attention) counts on it.
* bytes: the operands plus the result of each local op that is not a view,
  which is hlo's `hbm_bytes_raw` (`hlo.py:193-235`), plus the kernels'
  recorded bytes.  XLA fuses elementwise chains and counts a fusion's
  operands and result once; the port's eager ops each read and write
  memory, so its count is higher by every intermediate a fusion would keep
  on chip.  Collectives' buffers are counted under collectives, not here.
* collective bytes by kind, with JAX's conventions (`hlo.py:155-175`,
  `dryrun.py:76-90`): an all-reduce twice its buffer, a reduce-scatter its
  operand, the others (all-gather, all-to-all) their result.
* the peak of live tensor bytes: each local tensor's storage counted from
  the op that makes it until it is freed (a weak reference's finalizer).

What XLA's analysis has and this lacks: fusion (above), and a static
schedule; this peak is that of the eager program's own order of frees.

DTensor's sharding propagation runs small real ops (index arithmetic) and
ops at global shapes on fake tensors (to learn an output's shape), and a
strided shard's size and offset come from index tensors read back to the
host.  Under a fake mode these would run in the mode, where reading an
index back fails (a fake tensor has no values) and the global-shape ops
would count as the rank's work, and propagation would skip its cache.
While `StepTrace` is entered, both run outside the mode, propagation
through DTensor's own cache (`_index_math_outside`).
"""
from __future__ import annotations

import contextlib
import gc
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import abstract

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "device", "sym_size", "sym_stride", "sym_numel"}


def collective_kind(name: str) -> str:
    """JAX's kind of a collective op (an op name such as
    `_c10d_functional::all_gather_into_tensor`)."""
    for key, kind in (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all")):
        if key in name:
            return kind
    return "collective-permute"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class StepTrace(FakeTensorMode):
    """A FakeTensorMode that counts rank 0's work per device (see the
    module's docstring).  Build the step's arguments under it, then open
    `counting()` around the step."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.collective_calls: Dict[str, int] = defaultdict(int)
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._counting = False
        self._entered = 0
        self._unpatch = None

    # -- bookkeeping ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        if self._counting:
            self.kernel_flops += flops
            self.kernel_bytes += nbytes

    def __enter__(self):
        if self._entered == 0:
            self._unpatch = _index_math_outside()
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._entered -= 1
            if self._entered == 0:
                self._unpatch()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        ins = _tensors((args, kwargs))
        if any(isinstance(x, DTensor) for x in ins):
            return out          # the DTensor op: its local ops are counted
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if not self._counting:
            return out
        name = func.name()
        if name.split("::")[0] in _COLLECTIVE_NAMESPACES and "wait" not in name:
            kind = collective_kind(name)
            nbytes = sum(map(_nbytes, ins if kind in ("all-reduce", "reduce-scatter") else outs))
            self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) + (
                2.0 * nbytes if kind == "all-reduce" else float(nbytes))
            self.collective_calls[kind] += 1
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **(kwargs or {}), out_val=out))
        if not func.is_view and func.__name__.split(".")[0] not in _NO_TRAFFIC:
            self.bytes += float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        return out

    # -- a counted region -----------------------------------------------------
    @contextlib.contextmanager
    def counting(self) -> Iterator[None]:
        """Count the ops and kernels run inside; the peak restarts from the
        bytes live on entry (the step's arguments)."""
        gc.collect()
        self.peak = self.live
        self._counting = True
        try:
            with abstract.recording(self._record_kernel):
                yield
        finally:
            self._counting = False

    def totals(self) -> Dict[str, Any]:
        return {"flops": self.flops + self.kernel_flops,
                "bytes": self.bytes + self.kernel_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_calls": dict(self.collective_calls),
                "kernel_flops": self.kernel_flops, "kernel_bytes": self.kernel_bytes,
                "peak_bytes": self.peak}


def local_bytes(tree) -> int:
    """Bytes a rank holds for the tensors of `tree`: each DTensor's local
    shard, each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        key = loc.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += loc.untyped_storage().nbytes()
    return total


def shared_bytes(a, b) -> int:
    """Bytes of the storages a rank holds in both `a` and `b` (an output
    that is an argument updated in place, where JAX donates it)."""
    def keys(tree):
        return {(t.to_local() if isinstance(t, DTensor) else t).untyped_storage()._cdata:
                (t.to_local() if isinstance(t, DTensor) else t).untyped_storage().nbytes()
                for t in _tensors(tree)}
    ka, kb = keys(a), keys(b)
    return sum(n for k, n in ka.items() if k in kb)


def _index_math_outside():
    """Run DTensor's sharding propagation (routed from its uncached entry,
    which it calls under a fake mode, to its cached one) and a strided
    shard's local size and offset with no fake mode; returns the undo."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def propagate(prop, op_schema):
        with unset_fake_temporarily():
            return prop.propagate_op_sharding(op_schema)

    def outside(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    patches = [(ShardingPropagator, "propagate_op_sharding_non_cached", propagate)]
    orig_sizes = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if orig_sizes is not None:
        patches.append((_StridedShard, "local_shard_size_and_offset", outside(orig_sizes)))
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    for cls, name, fn in patches:
        setattr(cls, name, fn)

    def undo():
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return undo

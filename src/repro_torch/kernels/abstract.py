"""The kernels' abstract path: what a wrapper does with a fake tensor.

A wrapper given a `FakeTensor` (`torch._subclasses.fake_tensor`: a tensor
with a shape, dtype and device but no memory, as the dry run traces a step)
launches nothing.  It returns outputs of the shape, dtype and device the
kernel would write, made from its input (`new_empty`, so they are fake
too), counts the call in its own `<wrapper>.traced` (`.launches` stays the
count of real launches) and hands the kernel's work, FLOPs and bytes from
the shapes it was given, to every recorder installed by `recording`
(`analysis/trace.py` installs one).  The work is counted by the formulas of
`chip_smoke.py`'s bounds: each input read once and each output written
once; attention by its causal pairs.

The test is `isinstance(x, FakeTensor)`, made before the device test: a fake
CPU tensor traces the card's path, not the plain version's.  A real tensor
never reaches this module.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List

from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["FakeTensor", "causal_pairs", "recording", "traced"]

# plain module state, not a context variable: the backward runs the
# wrappers on autograd's own threads
_RECORDERS: List[Callable[[str, float, float], None]] = []


@contextlib.contextmanager
def recording(fn: Callable[[str, float, float], None]) -> Iterator[None]:
    """fn(wrapper name, flops, bytes) for every traced call while open."""
    _RECORDERS.append(fn)
    try:
        yield
    finally:
        _RECORDERS.remove(fn)


def traced(wrapper, outputs, flops: float, nbytes: float):
    """Count a fake call of `wrapper` and record its work; returns `outputs`."""
    wrapper.traced += 1
    for fn in list(_RECORDERS):
        fn(wrapper.__name__, float(flops), float(nbytes))
    return outputs


def causal_pairs(b: int, h: int, s: int, *, kv_len: int, q_offset: int = 0,
                 causal: bool = True) -> int:
    """(query row, key column) pairs a masked attention computes: query i
    sees columns j < kv_len and, when causal, j <= q_offset + i; B H of
    them.  q_offset 0 and kv_len S give B H S (S + 1) / 2."""
    if not causal:
        return b * h * s * kv_len
    # rows whose window is cut at kv_len, and the triangle before them
    full = max(0, min(s, s - (kv_len - q_offset - 1)))      # rows i >= kv_len - q_offset - 1
    tri = s - full
    lo, hi = q_offset + 1, q_offset + tri                   # columns seen by rows 0 .. tri-1
    seen = (lo + hi) * tri // 2 if tri > 0 else 0
    return b * h * (seen + full * max(0, kv_len))

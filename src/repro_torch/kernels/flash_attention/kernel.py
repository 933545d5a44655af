"""Flash attention forward and backward: the wrappers of the CUDA kernels in
`csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`.

Counterparts of `repro/kernels/flash_attention/kernel.py::flash_attention_fwd`
and `::flash_attention_bwd`; the backward's two passes (dq, then dk/dv) are
two wrappers, as they are two Pallas kernels.  Unlike the Pallas grids, the
kernels take an explicit `q_offset` and `kv_len`, mask tails that are not a
multiple of their tile, read strided views, and give dk/dv per kv head: the
dk/dv pass splits each kv tile's GQA group over a cluster of blocks
(`dkv_cluster_size`, `dkv_heads`) and sums their fp32 partials through
distributed shared memory in a fixed order, so no per-head buffer is
written and the same inputs give the same bits.  The dq pass is a persistent
grid walking work items heavy-first, each giving its two consumer
warpgroups a 64-row q tile apiece, both reading one K/V ring: at rep >= 2 a
tile of two query heads of a GQA group, at rep 1 (MHA) two adjacent tiles
of one head.  The kernel numbers the items itself; `dq_items` mirrors that
numbering, and the card tests hold every head and tile against the plain
version (rep 1 with an odd number of q tiles, 3 and 16, S not a multiple of
64: tests/test_torch_cuda.py).

Head dim 80 (stablelm-3b): every pass takes each of `HEAD_DIMS` as it is.
A tile of 80 columns is a 64-column slab and a 16-column tail slab, each
with its own swizzle (csrc/hopper_sm90.cuh), so q, k, v, out, dO and the
cache are read as they are, with no padded copy.

q/k head dim D and v head dim DV may differ where `HEAD_DIM_PAIRS` lists
the pair: MLA's expanded branch attends at D 192 ([nope | rope]) against
DV 128 (deepseek-v2-lite-16b).  out, dO and dv are [..., DV]; q, k, dq and
dk [..., D].  Every pass takes it natively: v is not padded.

A fake tensor takes the abstract path (`kernels/abstract.py`: outputs
without a launch, counted in `<wrapper>.traced`, the work by causal pairs)
after the checks a CUDA tensor meets, so it refuses what the kernel
refuses; a CPU tensor the plain version; a CUDA tensor launches the kernel
or raises.  `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..abstract import FakeTensor, causal_pairs, traced
from .ref import attention_bwd_dkv_ref, attention_bwd_dq_ref, attention_with_lse_ref

HEAD_DIMS = (32, 64, 80, 128)      # every pass's kernel takes each of them
# (q/k head dim, v head dim): each of HEAD_DIMS with itself, and MLA's
# [nope | rope] keys (128 + 64) against its v head dim 128
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_ARGTYPES = (_build.PTR,) * 5 + (_build.INT,) * 9 + (
    _build.FLOAT, _build.PTR, _build.PTR)
_BWD_ARGTYPES = (_build.PTR,) * 8 + (_build.INT,) * 10 + (
    _build.FLOAT, _build.PTR, _build.PTR)
_DKV_ARGTYPES = (_build.PTR,) * 8 + (_build.INT,) * 11 + (
    _build.FLOAT, _build.PTR, _build.PTR)
DKV_CLUSTERS = (1, 2, 4, 8)
_TILE = 64                  # rows of every tile of csrc/flash_attention_bwd.cu
_SMS = 132                  # SMs of an H100 (and H200) SXM


def dkv_cluster_size(rep: int, blocks: int) -> int:
    """Blocks of the cluster that splits one kv tile's GQA group of `rep`
    query heads in the dk/dv pass, given `blocks` = B x Hkv x kv tiles: the
    largest of 1, 2, 4, 8 that is at most `rep` and keeps the grid within
    two blocks an SM.  One block is resident on an SM at a time; past two
    waves, more and shorter blocks lose more to the cluster's reduction and
    to waiting for a whole cluster of free SMs than they gain in balance
    (at the train shape C = 2 beats 1, 4 and 8: PERF.md)."""
    c = 1
    while 2 * c <= min(rep, DKV_CLUSTERS[-1]) and 2 * c * blocks <= 2 * _SMS:
        c *= 2
    return c


def dkv_heads(rep: int, cluster: int, rank: int) -> range:
    """The query heads of a GQA group (0 .. rep-1) that block `rank` of a
    dk/dv cluster walks; empty when rep < cluster.  The kernel computes the
    same split."""
    return range(rank * rep // cluster, (rank + 1) * rep // cluster)


class DqItem(NamedTuple):
    """A dq work item: batch, its two warpgroups' (head, q tile) slots
    (None: the warpgroup idles), and the kv tiles the item streams."""
    b: int
    slots: Tuple[Optional[Tuple[int, int]], Optional[Tuple[int, int]]]
    n_tiles: int


def dq_items(b: int, h: int, hkv: int, s: int, *, kv_len: Optional[int] = None,
             q_offset: int = 0, causal: bool = True) -> List[DqItem]:
    """The dq pass's work items in the kernel's order (`dq_item` in
    csrc/flash_attention_bwd.cu numbers them the same way).  At rep = h /
    hkv >= 2 an item is a q tile of two query heads of one GQA group (the
    second slot empty for an odd group's last pair); at rep 1 two adjacent
    q tiles of one head, paired from the last tile down (the first slot
    empty for tile 0 when the number of tiles is odd).  Items with the most
    kv tiles come first."""
    rep, n_qt = h // hkv, -(-s // _TILE)
    kv_len = s if kv_len is None else kv_len

    def kv_tiles(q0: int) -> int:
        end = min(kv_len, q_offset + min(q0 + _TILE, s)) if causal else kv_len
        return -(-end // _TILE) if end > 0 else 0

    tiles2 = rep == 1
    n_pairs = 1 if tiles2 else (rep + 1) // 2
    per = b * hkv * n_pairs
    items = []
    for w in range((n_qt + 1) // 2 * b * hkv if tiles2 else n_qt * per):
        qt_last = n_qt - 1 - (2 if tiles2 else 1) * (w // per)
        r = w % per
        pair, hk, bb = r % n_pairs, (r // n_pairs) % hkv, r // (n_pairs * hkv)
        slots = []
        for wg in range(2):
            hg, qt = (0, qt_last - 1 + wg) if tiles2 else (2 * pair + wg, qt_last)
            slots.append((hk * rep + hg, qt) if hg < rep and qt >= 0 else None)
        items.append(DqItem(bb, tuple(slots), kv_tiles(qt_last * _TILE)))
    return items


def _check(name: str, q, k, v, kv_len: int, q_offset: int) -> None:
    b, h, s, d = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[-1]
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _build.require(x, arg, torch.bfloat16, q.device)
    if (k.shape != (b, hkv, t, d) or v.shape != (b, hkv, t, dv) or h % hkv
            or (d, dv) not in HEAD_DIM_PAIRS or not 0 <= kv_len <= t or q_offset < 0):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len {kv_len}, "
            f"q_offset {q_offset} ((q/k, v) head dims must be one of {HEAD_DIM_PAIRS})")


def _check_like(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    """A [B,H,S,D] view read in vectors, or a contiguous [B,H,S] lse/delta
    read one value at a time."""
    _build.require(x, name, dtype, device, vector=dtype == torch.bfloat16)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got {tuple(x.shape)}")


def _strides(*ts) -> ctypes.Array:
    """(batch, head, row) element strides of each tensor; None gives zeros."""
    vals = []
    for t in ts:
        vals.extend(t.stride()[:3] if t is not None else (0, 0, 0))
    return (ctypes.c_int64 * len(vals))(*vals)


def _empty_like_heads(x: torch.Tensor, d: Optional[int] = None) -> torch.Tensor:
    """[B,H,S,d] view of a new contiguous [B,S,H,d] tensor (d: x's last dim
    unless given): the model's layout, so the caller's transpose back is
    free."""
    b, h, s, dx = x.shape
    d = dx if d is None else d
    return x.new_empty((b, s, h, d)).transpose(1, 2)


def _fake_work(q, k, v, kv_len, q_offset, causal, n_qk, n_v, qk_rows, kv_rows):
    """(flops, bytes) of a pass: 2 (n_qk D + n_v DV) flops a causal pair;
    `qk_rows` [B,H,S] tensors of D and DV columns each read or written
    (q and dq; out and dO), `kv_rows` of K and V ([B,Hkv,kv_len]), and two
    fp32 [B,H,S] rows (lse, delta)."""
    b, h, s, d = q.shape
    dv = v.shape[-1]
    pairs = causal_pairs(b, h, s, kv_len=kv_len, q_offset=q_offset, causal=causal)
    nbytes = (qk_rows * b * h * s * (d + dv) + kv_rows * b * k.shape[1] * kv_len * (d + dv)
              ) * q.element_size() + 2 * b * h * s * 4
    return 2 * pairs * (n_qk * d + n_v * dv), nbytes


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None, causal: bool = True,
                        q_offset: int = 0, kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,S,D]; k [B,Hkv,T,D]; v [B,Hkv,T,DV] -> (out [B,H,S,DV], lse
    [B,H,S] fp32).

    Query row i attends to columns j < kv_len (default T) and, when causal,
    j <= q_offset + i.  With q_offset = 0 and kv_len = S = T this is the
    Pallas kernel's top-left-aligned causal mask.  On CUDA, `out` is a
    [B,H,S,DV] view of a contiguous [B,S,H,DV] tensor.
    """
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    fake = isinstance(q, FakeTensor)
    if not (fake or q.is_cuda):
        return attention_with_lse_ref(q, k, v, scale, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
    _check("flash_attention_fwd", q, k, v, kv_len, q_offset)
    if fake:                            # q read, out and lse written, K and V read
        out, lse = _empty_like_heads(q, v.shape[-1]), q.new_empty((b, h, s), dtype=torch.float32)
        flops, nbytes = _fake_work(q, k, v, kv_len, q_offset, causal, 1, 1, 1, 1)
        return traced(flash_attention_fwd, (out, lse), flops, nbytes - b * h * s * 4)
    dv = v.shape[-1]
    out = _empty_like_heads(q, dv)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_fwd_bf16", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, s, d, dv, kv_len, int(q_offset), int(causal),
            float(scale), _strides(q, k, v, out), _build.stream(q))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.traced = 0


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                           scale: Optional[float] = None, causal: bool = True,
                           q_offset: int = 0, kv_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq pass (counterpart of `_bwd_dq_kernel`): q [B,H,S,D]; out, do
    [B,H,S,DV]; k [B,Hkv,T,D]; v [B,Hkv,T,DV]; lse [B,H,S] fp32 from the
    forward -> (dq [B,H,S,D], delta [B,H,S] fp32 = rowsum(out * do)), with
    the forward's mask."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    fake = isinstance(q, FakeTensor)
    if not (fake or q.is_cuda):
        return attention_bwd_dq_ref(q, k, v, out, do, lse, scale, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)
    _check("flash_attention_bwd_dq", q, k, v, kv_len, q_offset)
    dv = v.shape[-1]
    _check_like("out", out, (b, h, s, dv), torch.bfloat16, q.device)
    _check_like("do", do, (b, h, s, dv), torch.bfloat16, q.device)
    _check_like("lse", lse, (b, h, s), torch.float32, q.device)
    if fake:                            # q, out, dO read, dq written; lse read, delta written
        outs = (_empty_like_heads(q), q.new_empty((b, h, s), dtype=torch.float32))
        return traced(flash_attention_bwd_dq, outs,
                      *_fake_work(q, k, v, kv_len, q_offset, causal, 2, 1, 2, 1))
    dq = _empty_like_heads(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd_dq_bf16", _BWD_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, hkv, s, t, d, dv,
            kv_len, int(q_offset), int(causal), float(scale),
            _strides(q, k, v, out, do, dq, None, None), _build.stream(q))
    _build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.traced = 0


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                            scale: Optional[float] = None, causal: bool = True,
                            q_offset: int = 0, kv_len: Optional[int] = None,
                            cluster: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv pass (counterpart of `_bwd_dkv_kernel` plus the GQA sum at
    kernel.py:262-264): q [B,H,S,D]; do [B,H,S,DV]; k [B,Hkv,T,D]; v
    [B,Hkv,T,DV] -> (dk [B,Hkv,T,D], dv [B,Hkv,T,DV]); rows at or past
    kv_len get zeros.  `cluster` (one of DKV_CLUSTERS; default `dkv_cluster_size`) is
    the number of blocks that split each kv tile's GQA group."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    fake = isinstance(q, FakeTensor)
    if not (fake or q.is_cuda):
        return attention_bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len)
    _check("flash_attention_bwd_dkv", q, k, v, kv_len, q_offset)
    _check_like("do", do, (b, h, s, v.shape[-1]), torch.bfloat16, q.device)
    _check_like("lse", lse, (b, h, s), torch.float32, q.device)
    _check_like("delta", delta, (b, h, s), torch.float32, q.device)
    if cluster is None:
        cluster = dkv_cluster_size(h // hkv, b * hkv * -(-t // _TILE))
    if cluster not in DKV_CLUSTERS:
        raise ValueError(f"flash_attention_bwd_dkv: cluster must be one of "
                         f"{DKV_CLUSTERS}, got {cluster}")
    if fake:                            # q, dO read; K, V read, dk, dv written
        return traced(flash_attention_bwd_dkv, (_empty_like_heads(k), _empty_like_heads(v)),
                      *_fake_work(q, k, v, kv_len, q_offset, causal, 2, 2, 1, 2))
    dk, dv = _empty_like_heads(k), _empty_like_heads(v)
    fn = _build.function("flash_attention_bwd_dkv_bf16", _DKV_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, t, d,
            v.shape[-1], kv_len, int(q_offset), int(causal), int(cluster), float(scale),
            _strides(q, k, v, None, do, None, dk, dv), _build.stream(q))
    _build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.traced = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, scale: Optional[float] = None,
                        causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None):
    """(dq, dk, dv): the dq pass, then the dk/dv pass on its delta.  The
    counterpart of the JAX `flash_attention_bwd`, with the same argument
    order; dk/dv come per kv head."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv

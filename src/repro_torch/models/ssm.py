"""Mamba2 (SSD) layer of the port: the serve and train paths.

Counterpart of `repro/models/ssm.py`, with the same names and layouts.  A
prompt or a training sequence (s > 1, or no state) goes through the SSD
scan's autograd op (`repro_torch.kernels.ssd_scan.ssd_scan_op`: the scan
kernel forward, its backward kernel under autograd), started from the
cache's state when there is one; one decode token (s == 1 with a state)
runs the O(1) recurrence
    h_t = a_t * h_{t-1} + (dt_t x_t) outer B_t ;  y_t = C_t . h_t + D x_t
in plain torch, as JAX leaves it to XLA.  The JAX `prefill` runs that
recurrence over the whole prompt, and JAX trains through `ssd_chunked`;
the scan computes the same function chunk by chunk.  The gated `out_norm`
is the RMSNorm kernel.

Under a mesh (DTensor activations, the params at JAX's table) the mixer
runs on each rank's share in `local_map` and never whole on every model
rank; the RMSNorm kernel always gets whole rows:

* train and prefill, where the SSD heads divide "model": the sequence is
  gathered, each rank projects the columns of its own heads (z, x, dt) and
  the whole B and C from the whole `in_proj` (gathered at use, its gradient
  a partial sum), convolves those channels and scans its heads; the gated
  rows go back to the sequence split (an all-to-all) for the norm and the
  token-local `out_proj`;
* train and prefill otherwise (full-width mamba2-130m's 24 heads on 16):
  each rank keeps its piece of the sequence and projects it whole; the conv
  reads the last W - 1 inputs of the previous piece, and the scan runs in
  two passes: each piece scans from zeros, the pieces' final states and
  decays are gathered (fp32 [n, B, H, P, N], [n, B, H]) and folded into
  each piece's true initial state, from which it scans again
  (`_sequence_split_mixer`);
* decode (one token, a cache of DTensors at `cache_specs`): each rank
  convolves the channels of its part of the conv state and steps the heads
  of its part of the scan state, in place (both whole where they do not
  divide "model"), gathering only the token's conv outputs; it gates its
  slice of d_inner (`_decode_mixer`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig, SSMConfig
from ..context import keep_shards
from ..kernels.ssd_scan import ssd_scan_op
from .layers import _dense_init, _local_rows, _placed, _product, _whole, apply_norm

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return dict(d_inner=d_inner, n_heads=n_heads, head_dim=s.head_dim,
                d_state=s.d_state, n_groups=s.n_groups, d_conv=s.d_conv,
                conv_dim=d_inner + 2 * s.n_groups * s.d_state)


def init_ssm(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    dm = ssm_dims(cfg)
    d = cfg.d_model
    in_dim = 2 * dm["d_inner"] + 2 * dm["n_groups"] * dm["d_state"] + dm["n_heads"]
    h = dm["n_heads"]
    return {
        "in_proj": _dense_init(gen, (d, in_dim), d, device),
        "conv_w": _dense_init(gen, (dm["d_conv"], dm["conv_dim"]), dm["d_conv"], device),
        "conv_b": torch.zeros(dm["conv_dim"], dtype=torch.bfloat16, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones(h, dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=device),
        "out_norm": torch.ones(dm["d_inner"], dtype=torch.bfloat16, device=device),
        "out_proj": _dense_init(gen, (dm["d_inner"], d), dm["d_inner"], device),
    }


def ssm_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of `init_ssm`'s leaves, JAX's."""
    return {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "A_log": ("heads_nosplit",), "D": ("heads_nosplit",),
            "dt_bias": ("heads_nosplit",), "out_norm": ("mlp",),
            "out_proj": ("mlp", "embed")}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    dm = ssm_dims(cfg)
    di, gn = dm["d_inner"], dm["n_groups"] * dm["d_state"]
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn, dm["n_heads"]], dim=-1)
    return z, xbc, dt  # gate, conv input, dt logits


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), JAX's formula: `F.silu` rounds differently in the last
    fp32 bit, and a bf16 cast after it then rounds some values the other way."""
    return x * torch.sigmoid(x)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over S.  xbc [B,S,C]; w [W,C].  Returns (y,
    new_state), new_state being the trailing W-1 inputs for decode.  As in
    JAX, the shifted products are rounded to xbc's dtype and summed in
    order, then the bias is added, then silu in fp32."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                         # [B, S+W-1, C]
    s = xbc.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return _silu(y.float()).to(xbc.dtype), new_state


def _recurrence(xt: torch.Tensor, dtt: torch.Tensor, a_log: torch.Tensor,
                Bt: torch.Tensor, Ct: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence, fp32: xt [B,H,P], dtt [B,H], Bt, Ct [B,N],
    h [B,H,P,N] -> (y [B,H,P], the new h)."""
    a = torch.exp(dtt * -torch.exp(a_log.float()))                # [B,H]
    h = (h.float() * a[..., None, None]
         + torch.einsum("bhp,bn->bhpn", xt.float() * dtt[..., None], Bt.float()))
    return torch.einsum("bhpn,bn->bhp", h, Ct.float()), h


def _gate(y: torch.Tensor, x: torch.Tensor, d_ch: torch.Tensor, z: torch.Tensor,
          dtype) -> torch.Tensor:
    """(y + D x) * silu(z), rounded to `dtype`: y [B,s,c] fp32, x and z [B,s,c]
    of the same channels, d_ch [c] (each head's D over its channels)."""
    return ((y + x.float() * d_ch) * _silu(z.float())).to(dtype)


def _channel_d(d: torch.Tensor, head_dim: int) -> torch.Tensor:
    """D [H] over the channels of its heads: [H * P]."""
    return d[:, None].expand(d.shape[0], head_dim).reshape(-1)


def ssm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            state: Optional[Dict[str, torch.Tensor]] = None):
    """Full Mamba2 block.  x [B,s,d]; `state` ({"conv": [B,W-1,C] bf16,
    "ssm": [B,H,P,N] fp32}) is the cache's; None starts from zeros.
    Returns (out [B,s,d], new_state), the state as new tensors.  A DTensor
    x takes the sharded path (`_ssm_fwd_sharded`)."""
    if isinstance(x, DTensor):
        return _ssm_fwd_sharded(p, x, cfg, state)
    dm = ssm_dims(cfg)
    proj = torch.einsum("bsd,di->bsi", x, p["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    di, gn = dm["d_inner"], dm["n_groups"] * dm["d_state"]
    xs, B, C = torch.split(xbc, [di, gn, gn], dim=-1)          # views of xbc
    bsz, s = x.shape[0], x.shape[1]
    xh = xs.reshape(bsz, s, dm["n_heads"], dm["head_dim"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    if state is not None and s == 1:
        y, h_last = _recurrence(xh[:, 0], dt[:, 0], p["A_log"], B[:, 0], C[:, 0],
                                state["ssm"])
        y = y[:, None]
    else:
        y, h_last = ssd_scan_op(xh, dt, p["A_log"], B, C,
                                chunk=min(cfg.ssm.chunk, s),
                                h0=None if state is None else state["ssm"])

    y = _gate(y.reshape(bsz, s, di), xs, _channel_d(p["D"], dm["head_dim"]), z, x.dtype)
    # gated RMSNorm then output projection
    y = apply_norm({"scale": p["out_norm"]}, y)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": new_conv.to(torch.bfloat16), "ssm": h_last.float()}


# ---------------------------------------------------------------------------
# the mixer under a mesh
# ---------------------------------------------------------------------------

def _model_dim(mesh) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def _model_size(mesh) -> int:
    mi = _model_dim(mesh)
    return 1 if mi is None else mesh.size(mi)


def _ssm_fwd_sharded(p: Params, x: DTensor, cfg: ModelConfig, state):
    """`ssm_fwd` on DTensors: the mixer on each rank's share (see the
    module's docstring), then the gated norm on whole rows and `out_proj`
    through `layers._product`.  The new state comes at the cache's
    placements (None without a cache)."""
    m = _model_size(x.device_mesh)
    if state is not None and x.shape[1] == 1:
        gated, new_state = _decode_mixer(p, x, cfg, state)
    elif ssm_dims(cfg)["n_heads"] % m == 0:
        gated, new_state = _heads_mixer(p, x, cfg, state)
    else:
        gated, new_state = _sequence_split_mixer(p, x, cfg, state)
    y = apply_norm({"scale": p["out_norm"]}, gated)
    return _product("bsi,id->bsd", y, p["out_proj"]), new_state


def _grad_over(mesh, split) -> list:
    """The placements of a gradient each rank computes from its share: a
    partial sum on the mesh dims (of size > 1) in `split`."""
    return [Partial() if i in split and mesh.size(i) > 1 else Replicate()
            for i in range(mesh.ndim)]


def _state_inputs(state, mesh):
    """The cache's conv state with its channels gathered (batch split kept:
    [B, W-1, C], small) and its scan state as placed, or Nones."""
    if state is None:
        return None, None
    conv = state["conv"]
    return conv.redistribute(mesh, keep_shards(conv, (0,))), state["ssm"]


def _new_conv(conv0, pre, width):
    """The conv state after `pre` [B, k, c] (the last k <= W-1 inputs of
    these channels) follows `conv0` (the state before, or None: zeros)."""
    if conv0 is None:
        conv0 = pre.new_zeros((pre.shape[0], width - 1, pre.shape[2]))
    return torch.cat([conv0.to(pre.dtype), pre], dim=1)[:, -(width - 1):]


def _heads_mixer(p: Params, x: DTensor, cfg: ModelConfig, state):
    """The mixer where the SSD heads divide "model" (a train or prefill
    chunk): the sequence gathered, each rank its heads.  Returns the gated
    rows [B, s, d_inner] back at x's placements (the heads -> sequence
    all-to-all) and the new state at the cache's placements."""
    mesh, dm = x.device_mesh, ssm_dims(cfg)
    mi, m = _model_dim(mesh), _model_size(mesh)
    di, gn, hp = dm["d_inner"], dm["n_groups"] * dm["d_state"], dm["head_dim"]
    hl, width = dm["n_heads"] // m, dm["d_conv"]
    x_pl = list(x.placements)
    xg = _placed(x, keep_shards(x, (0,)))                        # the sequence gathered
    xpl = list(xg.placements)
    split = {i for i, q in enumerate(xpl) if q.is_shard()} | ({mi} if m > 1 else set())
    wgrad = _grad_over(mesh, split)
    conv0, h0 = _state_inputs(state, mesh)
    r = mesh.get_coordinate()[mi] if m > 1 else 0
    heads, ch = slice(r * hl, (r + 1) * hl), slice(r * hl * hp, (r + 1) * hl * hp)
    c0, cn = (0, 0) if state is None else _local_rows(state["conv"], 2)

    def conv_cols(t):       # the conv's channels of this rank's heads, then B and C
        return t if m == 1 else torch.cat([t[..., ch], t[..., di:]], dim=-1)

    def run(xl, w, cw, cb, a_log, d, dt_bias, conv_st, h_st):
        # in_proj's columns of this rank's heads: z, x, then B and C, then dt
        wl = w if m == 1 else torch.cat([w[:, ch], conv_cols(w[:, di:di + di + 2 * gn]),
                                         w[:, di + di + 2 * gn:][:, heads]], dim=1)
        proj = torch.einsum("bsd,di->bsi", xl, wl)
        z, xbc, dtr = torch.split(proj, [hl * hp, hl * hp + 2 * gn, hl], dim=-1)
        xc, conv_own = _causal_conv(xbc, conv_cols(cw), conv_cols(cb),
                                    None if conv_st is None else conv_cols(conv_st))
        xs, B, C = torch.split(xc, [hl * hp, gn, gn], dim=-1)
        b, s = xl.shape[:2]
        xh = xs.reshape(b, s, hl, hp)
        dt = F.softplus(dtr.float() + dt_bias[heads])
        y, h_last = ssd_scan_op(xh, dt, a_log[heads], B, C, chunk=min(cfg.ssm.chunk, s),
                                h0=h_st)
        gated = _gate(y.reshape(b, s, hl * hp), xs, _channel_d(d[heads], hp), z, xl.dtype)
        if conv_st is None:
            return gated
        if m == 1:
            conv_new = conv_own[..., c0:c0 + cn]
        else:   # the cache's own channels, from the last W-1 tokens' inputs
            k = min(s, width - 1)
            pre = torch.einsum("bsd,di->bsi", xl[:, s - k:], w[:, di + c0:di + c0 + cn])
            conv_new = _new_conv(conv_st[..., c0:c0 + cn], pre, width)
        return gated, conv_new.to(torch.bfloat16), h_last.float()

    rep = [Replicate()] * mesh.ndim
    gpl = [Shard(2) if i == mi else q for i, q in enumerate(xpl)]
    xgrad = [Partial() if i == mi and m > 1 else q for i, q in enumerate(xpl)]
    st_pl = (None, None) if state is None else (list(conv0.placements),
                                                list(h0.placements))
    outs = gpl if state is None else (gpl, list(state["conv"].placements),
                                      list(state["ssm"].placements))
    fn = local_map(run, out_placements=outs,
                   in_placements=(xpl, rep, rep, rep, rep, rep, rep, *st_pl),
                   in_grad_placements=(xgrad, wgrad, wgrad, wgrad, wgrad, wgrad, wgrad,
                                       *st_pl), device_mesh=mesh)
    res = fn(xg, _whole(p["in_proj"]), _whole(p["conv_w"]), _whole(p["conv_b"]),
             _whole(p["A_log"]), _whole(p["D"]), _whole(p["dt_bias"]), conv0, h0)
    gated, new_state = (res, None) if state is None else (res[0], {"conv": res[1],
                                                                    "ssm": res[2]})
    return _placed(gated, x_pl), new_state


# a differentiable all-gather along dim 0 (torch 2.13 names it anew)
_all_gather = (getattr(funcol, "all_gather_single_autograd", None)
               or funcol.all_gather_tensor_autograd)


def _gather_pieces(t: torch.Tensor, groups) -> torch.Tensor:
    """Every piece's `t`, [n, ...] in the sequence's order: gathered over
    the process groups of the mesh dims that split the sequence (in mesh
    order, outer first), differentiable."""
    out = t[None].contiguous()
    for g in reversed(groups):
        out = _all_gather(out, 0, g)
    return out


def _sequence_split_mixer(p: Params, x: DTensor, cfg: ModelConfig, state):
    """The mixer where the SSD heads do not divide "model" (a train or
    prefill chunk): each rank its piece of the sequence, whole.  The conv
    reads the previous piece's last W-1 inputs; the scan runs in two passes
    (the module's docstring).  Returns the gated rows [B, s, d_inner] at the
    tokens' placements and the new state at the cache's."""
    mesh, dm = x.device_mesh, ssm_dims(cfg)
    hp, width = dm["head_dim"], dm["d_conv"]
    proj = _product("bsd,di->bsi", x, p["in_proj"])
    proj = _placed(proj, keep_shards(proj, (0, 1)))
    ppl = list(proj.placements)
    seq = [i for i, q in enumerate(ppl) if q.is_shard(1) and mesh.size(i) > 1]
    groups = [mesh.get_group(i) for i in seq]
    n = math.prod(mesh.size(i) for i in seq)
    coord = mesh.get_coordinate()
    piece = 0
    for i in seq:
        piece = piece * mesh.size(i) + coord[i]
    wgrad = _grad_over(mesh, {i for i, q in enumerate(ppl) if q.is_shard()})
    conv0, h0 = _state_inputs(state, mesh)
    c0, cn = (0, 0) if state is None else _local_rows(state["conv"], 2)

    def run(pl, cw, cb, a_log, d, dt_bias, conv_st, h_st):
        z, xbc, dtr = _split_proj(cfg, pl)
        b, s = pl.shape[:2]
        gn = dm["n_groups"] * dm["d_state"]
        if n == 1:
            xc, conv_new = _causal_conv(xbc, cw, cb, conv_st)
        else:
            # every rank indexes what it gathered, the first piece too: the
            # gathers' backward then runs on every rank alike
            if s < width - 1:
                raise ValueError(f"a piece of {s} tokens is shorter than the conv's "
                                 f"{width - 1}-token reach")
            tails = _gather_pieces(xbc[:, s - (width - 1):], groups)   # [n, B, W-1, C]
            first = (xbc.new_zeros(tails.shape[1:]) if conv_st is None
                     else conv_st.to(xbc.dtype))
            xc, _ = _causal_conv(xbc, cw, cb, torch.cat([first[None], tails[:-1]])[piece])
            conv_new = tails[n - 1]
        xs, B, C = torch.split(xc, [dm["d_inner"], gn, gn], dim=-1)
        xh = xs.reshape(b, s, dm["n_heads"], hp)
        dt = F.softplus(dtr.float() + dt_bias)
        chunk = min(cfg.ssm.chunk, s)
        if n == 1:
            y, h_last = ssd_scan_op(xh, dt, a_log, B, C, chunk=chunk, h0=h_st)
        else:
            # pass 1 from zeros; each piece's final state and decay gathered
            # and folded, in order, into every piece's initial state; pass 2
            _, h_piece = ssd_scan_op(xh, dt, a_log, B, C, chunk=chunk)
            decay = torch.exp(-torch.exp(a_log) * dt.sum(1))          # [B, H]
            hs, ds = _gather_pieces(h_piece, groups), _gather_pieces(decay, groups)
            folds = [torch.zeros_like(h_piece) if h_st is None else h_st]
            for j in range(n):
                folds.append(ds[j][..., None, None] * folds[-1] + hs[j])
            folds = torch.stack(folds)                                 # [n + 1, B, H, P, N]
            y, _ = ssd_scan_op(xh, dt, a_log, B, C, chunk=chunk, h0=folds[piece].contiguous())
            h_last = folds[n]
        gated = _gate(y.reshape(b, s, -1), xs, _channel_d(d, hp), z, pl.dtype)
        if conv_st is None:
            return gated
        return gated, conv_new[..., c0:c0 + cn].to(torch.bfloat16), h_last.float()

    rep = [Replicate()] * mesh.ndim
    st_pl = (None, None) if state is None else (list(conv0.placements),
                                                list(h0.placements))
    outs = ppl if state is None else (ppl, list(state["conv"].placements),
                                      list(state["ssm"].placements))
    fn = local_map(run, out_placements=outs,
                   in_placements=(ppl, rep, rep, rep, rep, rep, *st_pl),
                   in_grad_placements=(ppl, wgrad, wgrad, wgrad, wgrad, wgrad, *st_pl),
                   device_mesh=mesh)
    res = fn(proj, _whole(p["conv_w"]), _whole(p["conv_b"]), _whole(p["A_log"]),
             _whole(p["D"]), _whole(p["dt_bias"]), conv0, h0)
    if state is None:
        return res, None
    return res[0], {"conv": res[1], "ssm": res[2]}


def _decode_mixer(p: Params, x: DTensor, cfg: ModelConfig, state):
    """One decode token against a cache of DTensors: each rank convolves
    the channels of its part of the conv state and steps the heads of its
    part of the scan state, both in its own new tensors at the cache's
    placements; the token's conv outputs are gathered (the scan reads every
    head's x, B and C), never the state.  Returns the gated rows, split over
    "model" by d_inner where it divides, and the new state."""
    mesh, dm = x.device_mesh, ssm_dims(cfg)
    mi, m = _model_dim(mesh), _model_size(mesh)
    di, gn, hp, h = dm["d_inner"], dm["n_groups"] * dm["d_state"], dm["head_dim"], dm["n_heads"]
    conv_dim = dm["conv_dim"]
    x = _placed(x, keep_shards(x, (0,)))
    xpl = list(x.placements)
    conv_st, ssm_st = state["conv"], state["ssm"]
    c0, cn = _local_rows(conv_st, 2)
    h0, hn = _local_rows(ssm_st, 1)
    split_gate = m > 1 and di % m == 0
    r = mesh.get_coordinate()[mi] if m > 1 else 0
    g0, gl = (r * di // m, di // m) if split_gate else (0, di)
    group = mesh.get_group(mi) if cn < conv_dim else None

    def run(xl, w, cw, cb, a_log, d, dt_bias, cst, hst):
        wl = w if (gl, cn) == (di, conv_dim) else torch.cat(
            [w[:, g0:g0 + gl], w[:, di + c0:di + c0 + cn], w[:, di + conv_dim:]], dim=1)
        proj = torch.einsum("bsd,di->bsi", xl, wl)
        z, xbc, dtr = torch.split(proj, [gl, cn, h], dim=-1)
        xc, conv_new = _causal_conv(xbc, cw[:, c0:c0 + cn], cb[c0:c0 + cn], cst)
        if group is not None:       # the token's conv outputs, every channel
            xc = _all_gather(xc.movedim(2, 0).contiguous(), 0, group).movedim(0, 2)
        xs, B, C = torch.split(xc, [di, gn, gn], dim=-1)
        b = xl.shape[0]
        xh = xs.reshape(b, 1, h, hp)
        dt = F.softplus(dtr.float() + dt_bias)
        heads = slice(h0, h0 + hn)
        y, h_new = _recurrence(xh[:, 0, heads], dt[:, 0, heads], a_log[heads], B[:, 0],
                               C[:, 0], hst)
        lo = g0 - h0 * hp                      # the gated slice within the stepped heads
        y = y.reshape(b, 1, hn * hp)[..., lo:lo + gl]
        gated = _gate(y, xs[..., g0:g0 + gl], _channel_d(d, hp)[g0:g0 + gl], z, xl.dtype)
        return gated, conv_new.to(torch.bfloat16), h_new.float()

    rep = [Replicate()] * mesh.ndim
    gpl = [Shard(2) if i == mi and split_gate else q for i, q in enumerate(xpl)]
    fn = local_map(run, out_placements=(gpl, list(conv_st.placements),
                                        list(ssm_st.placements)),
                   in_placements=(xpl, rep, rep, rep, rep, rep, rep, list(conv_st.placements),
                                  list(ssm_st.placements)), device_mesh=mesh)
    gated, conv_new, ssm_new = fn(x, _whole(p["in_proj"]), _whole(p["conv_w"]),
                                  _whole(p["conv_b"]), _whole(p["A_log"]), _whole(p["D"]),
                                  _whole(p["dt_bias"]), conv_st, ssm_st)
    # whole rows for the norm (a decode step's few tokens)
    return _placed(gated, xpl), {"conv": conv_new, "ssm": ssm_new}


def init_ssm_state(cfg: ModelConfig, batch: int, n_ssm_layers: int, device
                   ) -> Dict[str, torch.Tensor]:
    dm = ssm_dims(cfg)
    return {
        "conv": torch.zeros((n_ssm_layers, batch, dm["d_conv"] - 1, dm["conv_dim"]),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((n_ssm_layers, batch, dm["n_heads"], dm["head_dim"],
                            dm["d_state"]), dtype=torch.float32, device=device),
    }

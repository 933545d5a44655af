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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..kernels.ssd_scan import ssd_scan_op
from .layers import _dense_init, apply_norm

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


def ssm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            state: Optional[Dict[str, torch.Tensor]] = None):
    """Full Mamba2 block.  x [B,s,d]; `state` ({"conv": [B,W-1,C] bf16,
    "ssm": [B,H,P,N] fp32}) is the cache's; None starts from zeros.
    Returns (out [B,s,d], new_state), the state as new tensors."""
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

    y = y + xh.float() * p["D"][..., None]
    y = y.reshape(bsz, s, di)
    # gated RMSNorm then output projection
    y = apply_norm({"scale": p["out_norm"]},
                   (y * _silu(z.float())).to(x.dtype))
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": new_conv.to(torch.bfloat16), "ssm": h_last.float()}


def init_ssm_state(cfg: ModelConfig, batch: int, n_ssm_layers: int, device
                   ) -> Dict[str, torch.Tensor]:
    dm = ssm_dims(cfg)
    return {
        "conv": torch.zeros((n_ssm_layers, batch, dm["d_conv"] - 1, dm["conv_dim"]),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((n_ssm_layers, batch, dm["n_heads"], dm["head_dim"],
                            dm["d_state"]), dtype=torch.float32, device=device),
    }

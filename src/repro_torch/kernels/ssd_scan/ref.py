"""Plain PyTorch version of the SSD-scan kernel: a copy of
`repro/models/ssm.py::ssd_chunked` (the oracle of the Pallas kernel) that
also takes any sequence length."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x [B,S,H,P]; dt [B,S,H] (softplus'd); a_log [H] (A = -exp(a_log));
    B, C [B,S,N] (one group, shared by the heads); h0 [B,H,P,N] or None
    (zeros).  Returns y [B,S,H,P] and h_final [B,H,P,N], both fp32 (fp64
    when x is fp64: the high-precision reference of the scan's gradient).

    When S is not a multiple of `chunk`, x, dt, B and C are padded with zeros
    to the next multiple and the padded rows of y are dropped: with dt = 0 a
    padded row neither decays the state nor adds to it, so h_final is that of
    the unpadded sequence.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.to(ct).reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).to(ct)
    Cc = C.reshape(b, nc, chunk, n).to(ct)

    A = -torch.exp(a_log.to(ct))                                # [H]
    cum = torch.cumsum(dtc * A, dim=2)                          # within-chunk cumsum
    xdt = xc.to(ct) * dtc[..., None]                            # dt-scaled input

    # ---- intra-chunk (quadratic, causal-masked) ----
    # att[i,j] = exp(cum_i - cum_j) * (C_i . B_j),  j <= i; the exponent is
    # masked to -inf above the diagonal before exp, never the product after
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,NC,L,L,H]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # [B,NC,L,L]
    att = torch.exp(seg) * cb[..., None]                        # [B,NC,L,L,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xdt)

    # ---- chunk summary states ----
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)             # [B,NC,L,H]
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", dec_to_end, Bc, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,NC,H]

    # ---- inter-chunk recurrence (short sequential loop) ----
    hcur = (torch.zeros((b, h, p, n), dtype=ct, device=x.device)
            if h0 is None else h0.to(ct))
    h_enter = []
    for c in range(nc):
        h_enter.append(hcur)                                    # state ENTERING chunk c
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(h_enter, dim=1)                       # [B,NC,H,P,N]

    # ---- inter-chunk contribution ----
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum), h_enter)
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    return y, hcur


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor],
                     dy: torch.Tensor, dh_final: Optional[torch.Tensor], *, chunk: int = 256):
    """The gradient of `ssd_scan_ref`, by the chunked formulas the backward
    kernel evaluates (not autograd).

    dy [B,S,H,P] and dh_final [B,H,P,N] (or None: zeros) are the gradients
    on y and h_final.  Returns (dx, ddt, da_log, dB, dC, dh0), each in its
    input's dtype; dh0 is None when h0 is.  Per (batch, head) and chunk,
    with A = -exp(a_log), cum_i = sum_{k <= i} dt_k A, u_j = dt_j x_j,
    w_j = exp(cum_last - cum_j), H the state entering the chunk and G the
    gradient on the state leaving it (dh_final for the last chunk):

      dH  = exp(cum_last) G + sum_i exp(cum_i) dy_i C_i^T   (a reverse chain)
      du_j = sum_{i >= j} exp(cum_i - cum_j) (C_i . B_j) dy_i + w_j G B_j
      dx = dt du,  ddt = du . x + A sum_{i >= k} dcum_i
      dB_j, dC_i: summed over the heads, which share B and C
      da_log = sum dt A sum_{i >= k} dcum_i

    where dcum collects the gradient on each exponent.  Padding rows (S not
    a multiple of `chunk`) get dt = 0, as in `ssd_scan_ref`.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = -s % chunk
    f32 = torch.float32
    xf, dtf, Bf, Cf, dyf = x.float(), dt.float(), B.float(), C.float(), dy.float()
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    nc = (s + pad) // chunk
    xc = xf.reshape(b, nc, chunk, h, p)
    dyc = dyf.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc, Cc = Bf.reshape(b, nc, chunk, n), Cf.reshape(b, nc, chunk, n)

    A = -torch.exp(a_log.float())                               # [H]
    cum = torch.cumsum(dtc * A, dim=2)                          # [B,NC,L,H]
    u = xc * dtc[..., None]                                     # [B,NC,L,H,P]
    last = cum[:, :, -1]                                        # [B,NC,H]
    w = torch.exp(last[:, :, None] - cum)                       # [B,NC,L,H]
    ec = torch.exp(cum)
    decay = torch.exp(last)                                     # [B,NC,H]

    # the states entering each chunk (forward chain) and the gradients on
    # the states leaving each chunk (reverse chain)
    s_fwd = torch.einsum("bclh,bcln,bclhp->bchpn", w, Bc, u)
    s_bwd = torch.einsum("bclh,bclhp,bcln->bchpn", ec, dyc, Cc)
    hcur = torch.zeros((b, h, p, n), dtype=f32, device=x.device) if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(hcur)
        hcur = hcur * decay[:, c, :, None, None] + s_fwd[:, c]
    H = torch.stack(h_in, dim=1)                                # [B,NC,H,P,N]
    g = (torch.zeros((b, h, p, n), dtype=f32, device=x.device) if dh_final is None
         else dh_final.float())
    g_out = [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = g
        g = g * decay[:, c, :, None, None] + s_bwd[:, c]
    G = torch.stack(g_out, dim=1)                               # [B,NC,H,P,N]

    # intra-chunk: E_ij = exp(cum_i - cum_j) for j <= i, 0 above
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,NC,L,L,H]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    E = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                # [B,NC,L,L]
    dyu = torch.einsum("bcihp,bcjhp->bcijh", dyc, u)            # dy_i . u_j
    att = E * cb[..., None]
    ed = E * dyu
    m = att * dyu                                               # d loss / d seg_ij

    du_state = w[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, G)
    du = torch.einsum("bcijh,bcihp->bcjhp", att, dyc) + du_state
    dc_inter = ec[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, H)
    dB = (torch.einsum("bcijh,bcin->bcjn", ed, Cc)
          + torch.einsum("bcjhp,bchpn->bcjn", w[..., None] * u, G))
    dC = torch.einsum("bcijh,bcjn->bcin", ed, Bc) + dc_inter.sum(3)

    # the exponents: seg_ij = cum_i - cum_j; exp(cum_i) of the inter-chunk
    # output; cum_last - cum_j of the state update and cum_last of the decay
    st = (u * du_state).sum(-1)                                 # [B,NC,L,H]
    dcum = m.sum(3) - m.sum(2) + torch.einsum("bcihn,bcin->bcih", dc_inter, Cc) - st
    dcum[:, :, -1] += st.sum(2) + decay * (G * H).sum((-1, -2))
    rcum = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))   # sum_{i >= k}
    ddt = (du * xc).sum(-1) + A * rcum
    da_log = (dtc * A * rcum).sum((0, 1, 2))
    dx = du * dtc[..., None]

    def rows(t):
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]

    return (rows(dx).to(x.dtype), rows(ddt).to(dt.dtype), da_log.to(a_log.dtype),
            rows(dB).to(B.dtype), rows(dC).to(C.dtype),
            None if h0 is None else g.to(h0.dtype))

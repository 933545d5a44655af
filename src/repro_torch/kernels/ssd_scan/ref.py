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
    (zeros).  Returns y [B,S,H,P] and h_final [B,H,P,N], both fp32.

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
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    A = -torch.exp(a_log.float())                               # [H]
    cum = torch.cumsum(dtc * A, dim=2)                          # within-chunk cumsum
    xdt = xc.float() * dtc[..., None]                           # dt-scaled input

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
    hcur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if h0 is None else h0.float())
    h_enter = []
    for c in range(nc):
        h_enter.append(hcur)                                    # state ENTERING chunk c
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(h_enter, dim=1)                       # [B,NC,H,P,N]

    # ---- inter-chunk contribution ----
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum), h_enter)
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    return y, hcur

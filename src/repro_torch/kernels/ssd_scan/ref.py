"""Plain chunked SSD scan: the port's copy of ``repro.models.ssm._ssd_chunked``.

It is both the oracle and K5's plain version.  ``h0`` is the state
carried in (zeros when None), and a sequence that does not fill its last
chunk is padded with ``log_a = 0`` (decay 1) and ``B = 0``, which leaves
the final state unchanged.  One deliberate difference (ROADMAP.md queue
3): the intra-chunk decays are masked before their exponential, not
after, so that the gradient stays finite where a masked decay overflows
(the reference's gradient is NaN there); the values are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked"]


def ssd_chunked(
    x: torch.Tensor,          # (B, S, H, P), already scaled by dt
    log_a: torch.Tensor,      # (B, S, H) = dt · A (negative)
    Bm: torch.Tensor,         # (B, S, N)
    Cm: torch.Tensor,         # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P), final state (B, H, P, N)), both float32."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xr = x.float().reshape(b, nc, chunk, h, p)
    ar = log_a.float().reshape(b, nc, chunk, h)
    Br = Bm.float().reshape(b, nc, chunk, n)
    Cr = Cm.float().reshape(b, nc, chunk, n)

    a_cs = torch.cumsum(ar, dim=2)                                      # (b,nc,Q,h)
    # intra-chunk: L[i,j] = exp(cs_i - cs_j) for i >= j
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]               # (b,nc,Q,Q,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal seg = cs_i - cs_j > 0 can
    # pass 88 and exp() overflow, and the gradient of where(tri, exp(seg), 0)
    # there is 0 · inf = NaN (the reference's form); exp(-inf) = 0 gives the
    # same values and a finite gradient
    L = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    S = torch.einsum("bcin,bcjn->bcij", Cr, Br)                         # (b,nc,Q,Q)
    M = S[..., None] * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xr)

    # chunk summary states: sum_j exp(cs_Q - cs_j) B_j ⊗ x_j
    decay_out = torch.exp(a_cs[:, :, -1:, :] - a_cs)                    # (b,nc,Q,h)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Br, decay_out, xr)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])                          # (b,nc,h)

    h_run = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_run)
        h_run = h_run * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                                # (b,nc,h,p,n)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cr, torch.exp(a_cs), h_prev)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], h_run

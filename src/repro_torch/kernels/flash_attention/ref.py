"""Plain oracle for flash attention (GQA, causal/local/full).

The port's copy of ``repro.kernels.flash_attention.ref.mha_ref``: scores
in float32, masked with ``-inf``, softmax, weighted sum of V; the output
in ``q``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mha_ref"]


def mha_ref(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, KVH, D)
    v: torch.Tensor,          # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal or window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= kp <= qp
        if window:
            m &= kp > qp - window
        s = s.masked_fill(~m, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)

"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

The port's copy of ``repro.models.ssm``.  Prefill runs the chunked SSD
scan through K5 (:func:`repro_torch.kernels.ssd_scan.ssd_scan`), carrying
the state ``h0`` in: the CUDA kernel for CUDA tensors, its plain version
(the reference's ``_ssd_chunked``) for CPU tensors or when the caller
passes ``plain=True``.  Decode carries the recurrent state directly, O(1)
per token, in torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain
from .layers import ParamBuilder, rms_norm

__all__ = ["ssd_params", "SSMState", "init_ssm_state", "ssd_block"]


@dataclasses.dataclass
class SSMState:
    conv: torch.Tensor   # (B, conv_width-1, d_inner + 2*state) rolling conv inputs
    h: torch.Tensor      # (B, heads, head_dim, state) recurrent state, float32


def init_ssm_state(cfg: ModelConfig, batch: int, *, device="cuda") -> SSMState:
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=dt, device=device),
        h=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                      device=device),
    )


def ssd_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, di, n, nh, w = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    return {
        # z (gate), x, B, C, dt — one fused projection, mamba2-style
        "in_proj": b.param((d, 2 * di + 2 * n + nh)),
        "conv_w": b.param((w, di + 2 * n), scale=0.1),
        "conv_b": b.param((di + 2 * n,), init="zeros"),
        "A_log": b.param((nh,), init="uniform", scale=(0.0, 1.5)),
        "D": b.param((nh,), init="ones"),
        "dt_bias": b.param((nh,), init="uniform", scale=(-4.6, -2.3)),
        "norm": b.param((di,), init="zeros"),
        "out_proj": b.param((di, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (W,C) → (B,S,C)."""
    W, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):  # W is tiny (4)
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def ssd_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                    # (B, S, d)
    cfg: ModelConfig,
    *,
    state: Optional[SSMState] = None,
    decode: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """One SSD block.  Prefill (``decode=False``) with a ``state`` starts
    from ``state.h`` and returns the state decode continues from; decode
    takes one token and updates the state in place."""
    b, s, _ = x.shape
    di, n, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * n]
    dt_raw = zxbcdt[..., 2 * di + 2 * n:]
    A = -torch.exp(p["A_log"].float())                                  # (nh,) negative
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if decode:
        if state is None or s != 1:
            raise ValueError(f"decode takes one token and a state, got {s} tokens, "
                             f"state {'set' if state is not None else 'None'}")
        window = torch.cat([state.conv, xBC.to(state.conv.dtype)], dim=1)  # (B, W, C)
        conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        xBC_t = F.silu(conv_out)                                        # (B, C)
        xs = xBC_t[:, :di].reshape(b, nh, hd)
        Bm = xBC_t[:, di:di + n]
        Cm = xBC_t[:, di + n:]
        dt_t = dt[:, 0]                                                 # (B, nh)
        decay = torch.exp(dt_t * A[None, :])
        upd = torch.einsum("bh,bn,bhp->bhpn", dt_t, Bm, xs)
        h_new = state.h * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm, h_new)
        y = y + p["D"].float()[None, :, None] * xs
        y = y.reshape(b, 1, di)
        state.conv.copy_(window[:, 1:, :])
        state.h.copy_(h_new)
        new_state = state
    else:
        xBC_c = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]).float()).to(x.dtype)
        xs = xBC_c[..., :di].reshape(b, s, nh, hd)
        Bm = xBC_c[..., di:di + n].float().contiguous()
        Cm = xBC_c[..., di + n:].float().contiguous()
        x_dt = (xs.float() * dt[..., None]).contiguous()               # fold dt into x
        log_a = (dt * A[None, None, :]).contiguous()                    # (B, S, nh)
        h0 = state.h if state is not None else None
        scan = ssd_scan_plain if plain else ssd_scan
        y, h_final = scan(x_dt, log_a, Bm, Cm, chunk=cfg.ssm_chunk, h0=h0)
        y = y + p["D"].float()[None, None, :, None] * xs.float()
        y = y.reshape(b, s, di)
        new_state = None
        if state is not None:
            # decode continues from the last (W-1) pre-activation conv inputs
            w1 = cfg.conv_width - 1
            if s < w1:
                raise ValueError(f"prefill needs at least conv_width - 1 = {w1} tokens, got {s}")
            state.conv.copy_(xBC[:, s - w1:].to(state.conv.dtype))
            state.h.copy_(h_final)
            new_state = state

    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state

"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

The port's copy of ``repro.models.ssm``.  Prefill runs the depthwise
causal conv and its SiLU through one kernel
(:func:`repro_torch.kernels.causal_conv.causal_conv`) and the chunked SSD
scan through K5 (:func:`repro_torch.kernels.ssd_scan.ssd_scan`), carrying
the state ``h0`` in: the CUDA kernels for CUDA tensors, their plain
versions (the eager conv chain, the reference's ``_ssd_chunked``) for CPU
tensors or when the caller passes ``plain=True``.  Decode carries the
recurrent state directly, O(1) per token, in torch ops.

On a model axis larger than 1 (``tp``: training, prefill, decode) ``in_proj``'s
``ssm_inner`` columns are the concatenation z | x | B | C | dt, which a
column split cuts across, and the depthwise conv and the gated norm
read every column of their parts.  So ``in_proj``, ``conv_w``,
``conv_b`` and ``norm`` are gathered over ``model`` (their gradients
reduce-scattered back), ``A_log``, ``D`` and ``dt_bias`` (replicated)
enter through ``TensorParallel.shared``, and the layer up to the norm
runs replicated, K5 on every head.  ``out_proj`` is row-parallel on this
rank's columns of y, and its partial product leaves through
``reduce_from`` (``scatter_seq`` under sequence parallelism).  So the
state (:class:`SSMState`) is whole on every model rank, and every rank
updates it alike.  The reference's spec splits ``conv`` over
``act_mlp``; the port's whole state is a deliberate difference
(ROADMAP.md queue 3): at mamba2-130m's width ``conv`` is 3 × 1792 =
5376 values a row and layer (21 KiB in float32) on every rank, where
the reference keeps half of them on each of 2 model ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.causal_conv.causal_conv import causal_conv, causal_conv_plain
from ..kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain
from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder, model_split, rms_norm

__all__ = ["ssd_params", "SSMState", "init_ssm_state", "abstract_ssm_state", "ssm_state_specs",
           "ssd_block"]


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


def abstract_ssm_state(cfg: ModelConfig, batch: int) -> SSMState:
    """:func:`init_ssm_state`'s state as ``meta`` tensors."""
    return init_ssm_state(cfg, batch, device="meta")


def ssm_state_specs(cfg: ModelConfig, batch: int = 0) -> SSMState:
    """The state's logical axes, as the reference's."""
    return SSMState(conv=("act_batch", None, "act_mlp"), h=("act_batch", None, None, None))


def ssd_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, di, n, nh, w = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    return {
        # z (gate), x, B, C, dt — one fused projection, mamba2-style
        "in_proj": b.param((d, 2 * di + 2 * n + nh), ("embed", "ssm_inner")),
        "conv_w": b.param((w, di + 2 * n), (None, "conv_ch"), scale=0.1),
        "conv_b": b.param((di + 2 * n,), ("conv_ch",), init="zeros"),
        "A_log": b.param((nh,), ("ssm_heads",), init="uniform", scale=(0.0, 1.5)),
        "D": b.param((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": b.param((nh,), ("ssm_heads",), init="uniform", scale=(-4.6, -2.3)),
        "norm": b.param((di,), ("ssm_inner",), init="zeros"),
        "out_proj": b.param((di, d), ("ssm_inner", "embed")),
    }


def ssd_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                    # (B, S, d)
    cfg: ModelConfig,
    *,
    state: Optional[SSMState] = None,
    decode: bool = False,
    plain: bool = False,
    tp: Optional[TensorParallel] = None,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """One SSD block.  Prefill (``decode=False``) with a ``state`` starts
    from ``state.h`` and returns the state decode continues from; decode
    takes one token and updates the state in place.  ``tp``: see the
    module docstring."""
    di, n, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    split = tp is not None and tp.size > 1
    if split:
        x = tp.enter(x)
        out_proj, dims = p["out_proj"], model_split(tp, ssd_params, cfg)
        p = {k: tp.full(v, dims[k]) for k, v in p.items() if k != "out_proj"}
        if dims["out_proj"] != 0:
            raise NotImplementedError(f"out_proj's {di} rows do not split over {tp.size} "
                                      "model ranks")
    b, s, _ = x.shape

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
        conv = causal_conv_plain if plain else causal_conv
        xBC_c = conv(xBC, p["conv_w"], p["conv_b"], silu=True)
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
    if split:
        return tp.leave(y[..., tp.block(di)] @ out_proj), new_state
    return y @ p["out_proj"], new_state


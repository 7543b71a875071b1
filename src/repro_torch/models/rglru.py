"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port's copy of ``repro.models.rglru``:

    a_t = exp(c · r_t · log σ(Λ))                      (input-dependent decay)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill evaluates the linear recurrence as a log-depth scan of the
reference's combine ``(a_l·a_r, a_r·b_l + b_r)`` in float32: ⌈log₂ S⌉
Hillis–Steele steps over tensor slices (the reference runs
``jax.lax.associative_scan``, and no TPU kernel).  Not a loop over tokens
(one launch per token and layer), and not ``cumprod(a)`` with a divide
(``a`` reaches about 0.06, so the product underflows within a few hundred
steps).  Decode is the O(1) single-step update, written into the state in
place.  Gates use the paper's block-diagonal (8-block) projections.

The reference's casts are kept: in prefill the conv output is rounded to
``x``'s dtype and then taken to float32; in decode the conv runs in
float32 with no rounding.  A prefill with a carried state folds
``a_0 · h`` into the first step and, as the reference does, convolves the
prompt from zero padding, not from the carried conv inputs.

One deliberate difference (ROADMAP.md queue 3): a prefill's new conv
state is the last ``conv_width − 1`` rows of ``cat(state.conv, xb)``.
That equals the reference's ``xb[:, -(conv_width − 1):]`` whenever the
prompt has at least ``conv_width − 1`` tokens; with a shorter prompt the
reference's state has the wrong shape and its next decode fails.

On a model axis larger than 1 (``tp``: training, prefill, decode) the block is
column-parallel over this rank's block of ``lru``: ``w_x``, ``w_gate``,
the conv (``conv_ch``), the gate biases and ``lam`` are its blocks, and
the recurrence runs on its features alone.  The block-diagonal gates
(``_N_BLOCKS`` = 8 blocks, replicated) stay local where the model size
divides 8: the rank's features are whole blocks, and it takes those
blocks of ``gate_r_w`` / ``gate_i_w`` (entering through
``TensorParallel.shared``).  Otherwise every ``lru`` leaf is gathered
over ``model`` and the recurrence runs replicated.  ``w_out`` is
row-parallel on the rank's features, its partial product leaving
through ``reduce_from`` (``scatter_seq`` under sequence parallelism).
The state (:class:`RGLRUState`) holds the features the rank's
recurrence runs on: its block of ``lru``, or every feature where the
leaves are gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder, model_split
from .ssm import _causal_conv

__all__ = ["RGLRUState", "init_rglru_state", "abstract_rglru_state", "rglru_state_specs",
           "state_features", "rglru_params", "rglru_block"]

_C = 8.0          # the paper's fixed exponent scale
_N_BLOCKS = 8     # block-diagonal gate blocks


@dataclasses.dataclass
class RGLRUState:
    conv: torch.Tensor   # (B, conv_width-1, lru_width) the last conv inputs
    h: torch.Tensor      # (B, lru_width) recurrent state, float32


def _lw(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def state_features(cfg: ModelConfig, tp: Optional[TensorParallel] = None) -> slice:
    """The features of the recurrence that this model rank runs and keeps
    in its state."""
    lw = _lw(cfg)
    if tp is None or tp.size == 1 or _N_BLOCKS % tp.size:
        return slice(0, lw)
    per = lw // tp.size
    return slice(tp.rank * per, (tp.rank + 1) * per)


def init_rglru_state(cfg: ModelConfig, batch: int, *, device="cuda",
                     tp: Optional[TensorParallel] = None) -> RGLRUState:
    """An empty state; with ``tp``, of this rank's features."""
    sl = state_features(cfg, tp)
    lw = sl.stop - sl.start
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return RGLRUState(
        conv=torch.zeros((batch, cfg.conv_width - 1, lw), dtype=dt, device=device),
        h=torch.zeros((batch, lw), dtype=torch.float32, device=device),
    )


def abstract_rglru_state(cfg: ModelConfig, batch: int) -> RGLRUState:
    """:func:`init_rglru_state`'s state as ``meta`` tensors."""
    return init_rglru_state(cfg, batch, device="meta")


def rglru_state_specs(cfg: ModelConfig, batch: int = 0) -> RGLRUState:
    """The state's logical axes, as the reference's."""
    return RGLRUState(conv=("act_batch", None, "act_mlp"), h=("act_batch", "act_mlp"))


def rglru_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, lw, w = cfg.d_model, _lw(cfg), cfg.conv_width
    blk = lw // _N_BLOCKS
    return {
        "w_x": b.param((d, lw), ("embed", "lru")),
        "w_gate": b.param((d, lw), ("embed", "lru")),
        "w_out": b.param((lw, d), ("lru", "embed")),
        "conv_w": b.param((w, lw), (None, "conv_ch"), scale=0.1),
        "conv_b": b.param((lw,), ("conv_ch",), init="zeros"),
        # block-diagonal input/recurrence gates over the post-conv features
        "gate_r_w": b.param((_N_BLOCKS, blk, blk), (None, None, None)),
        "gate_r_b": b.param((lw,), ("lru",), init="zeros"),
        "gate_i_w": b.param((_N_BLOCKS, blk, blk), (None, None, None)),
        "gate_i_b": b.param((lw,), ("lru",), init="zeros"),
        # Λ init so that a = σ(Λ)^c lands in [0.9, 0.999]
        "lam": b.param((lw,), ("lru",), init="uniform", scale=(0.9, 4.0)),
    }


def _blockdiag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (..., lw) float32, w: (nb, blk, blk) → (..., lw) float32."""
    nb, blk, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, blk)
    y = torch.einsum("...nb,nbc->...nc", xs, w.float())
    return y.reshape(*x.shape[:-1], nb * blk) + b.float()


def _gates(p: Dict[str, torch.Tensor], xc: torch.Tensor):
    """log_a (float32, ≤ 0) and the input gate from post-conv features."""
    r = torch.sigmoid(_blockdiag(xc, p["gate_r_w"], p["gate_r_b"]))
    i = torch.sigmoid(_blockdiag(xc, p["gate_i_w"], p["gate_i_b"]))
    log_a = _C * r * F.logsigmoid(p["lam"].float())
    return log_a, i


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t from h_{-1} = 0 along dim 1, in ⌈log₂ S⌉
    steps: after the step of offset d, (a_t, b_t) combines positions
    t − 2d + 1 .. t."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, d)
    cfg: ModelConfig,
    *,
    state: Optional[RGLRUState] = None,
    decode: bool = False,
    tp: Optional[TensorParallel] = None,
) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """One RG-LRU block.  Prefill with a ``state`` continues from
    ``state.h`` and writes the state decode continues from; decode takes
    one token and updates the state in place.  ``tp``: see the module
    docstring."""
    split = tp is not None and tp.size > 1
    if split:
        x = tp.enter(x)
        p, features = _local_params(p, cfg, tp)
    s = x.shape[1]
    xb = x @ p["w_x"]
    gate = F.gelu((x @ p["w_gate"]).float(), approximate="tanh")

    if decode:
        if state is None or s != 1:
            raise ValueError(f"decode takes one token and a state, got {s} tokens, "
                             f"state {'set' if state is not None else 'None'}")
        window = torch.cat([state.conv, xb.to(state.conv.dtype)], dim=1)   # (B, W, lw)
        xc = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        log_a, i_g = _gates(p, xc)
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
        h_new = a * state.h + beta * (i_g * xc)
        y = h_new[:, None, :]
        state.conv.copy_(window[:, 1:, :])
        state.h.copy_(h_new)
    else:
        xc = _causal_conv(xb, p["conv_w"], p["conv_b"]).float()
        log_a, i_g = _gates(p, xc)
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
        bterm = beta * (i_g * xc)                                           # (B, S, lw)
        if state is not None:
            # fold the carried state into the first step's additive term
            bterm = torch.cat([bterm[:, :1] + a[:, :1] * state.h[:, None, :], bterm[:, 1:]],
                              dim=1)
        y = _linear_scan(a, bterm)
        if state is not None:
            w1 = cfg.conv_width - 1
            state.conv.copy_(torch.cat([state.conv, xb.to(state.conv.dtype)], dim=1)[:, -w1:])
            state.h.copy_(y[:, -1, :])

    if split:
        return tp.leave((gate * y)[..., features].to(x.dtype) @ p["w_out"]), state
    out = (gate * y).to(x.dtype) @ p["w_out"]
    return out, state


def _local_params(p: Dict[str, torch.Tensor], cfg: ModelConfig, tp: TensorParallel):
    """(the weights this rank computes with, its features' index into the
    recurrence's output) on a model axis larger than 1."""
    dims = model_split(tp, rglru_params, cfg)
    lw = _lw(cfg)
    for name in ("w_x", "w_gate", "w_out", "conv_w", "conv_b", "gate_r_b", "gate_i_b", "lam"):
        if dims[name] is None:
            raise NotImplementedError(f"an lru width of {lw} does not split over {tp.size} "
                                      "model ranks")
    p = dict(p)
    if _N_BLOCKS % tp.size == 0:         # whole gate blocks: the rank's own
        per = _N_BLOCKS // tp.size
        for name in ("gate_r_w", "gate_i_w"):
            p[name] = tp.shared(p[name])[tp.rank * per:(tp.rank + 1) * per]
        return p, slice(None)
    for name in ("w_x", "w_gate", "conv_w", "conv_b", "gate_r_b", "gate_i_b", "lam",
                 "gate_r_w", "gate_i_w"):
        p[name] = tp.full(p[name], dims[name])
    return p, tp.block(lw)

"""Mixture-of-Experts layer with ENEAC capacity-chunk dispatch.

The port's copy of ``repro.models.moe``.  The routing plan comes from
:mod:`repro_torch.core.moe_dispatch`: experts are the accelerators (a fixed
``capacity`` chunk each), the shared fallback FFN is the CPU-core path
that absorbs the overflow.

The reference has two dispatch strategies (``cfg.parallel.moe_dispatch``),
and on one device (no ``tp``) both take the global path:

* ``"local"`` (``_moe_ffn_local``, the reference's production path):
  each data-parallel shard routes its own tokens with a capacity of its
  own token count — one ENEAC worker per shard.  Within a model group
  the tokens are replicated (whole on the sequence dim under sequence
  parallelism), and each model rank serves what it holds: where the
  expert count divides the model axis, its ``E / model`` experts, by
  taking the plan's slots ``lo = rank · E_loc`` onward
  (:func:`_place_rows` puts their outputs back among zeros); otherwise
  every expert, tensor-parallel over ``expert_mlp``.  The fallback FFN
  is sliced along its hidden dim.  Every rank's combine is then partial,
  and one ``reduce_from`` over ``model`` completes it: the collective a
  dense FFN needs.  The four aux values are means over the data group
  (``pmean``), with their gradients.
* ``"gspmd"`` on a mesh: the one-device plan over the data group's
  tokens (all-gathered over the data axes; the backward reduce-scatters),
  the model rank's experts served as above, ``reduce_from``, and this
  rank's rows kept.

Routing, capacities and aux values are computed whole on every model
rank; the aux values leave the layer through ``TensorParallel.whole``.
No Pallas kernel is involved: the batched expert SwiGLU is three batched
matrix products.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import moe_dispatch as md
from ..parallel.collectives import gather_seq, pmean
from ..parallel.tensor_parallel import TensorParallel
from .ffn import ffn, ffn_params
from .layers import ParamBuilder

__all__ = ["moe_params", "moe_ffn", "moe_capacity"]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Static per-expert chunk (the ACC chunk size) for ``tokens`` per step,
    rounded up to a multiple of 8 as in the reference: the rounding decides
    which assignments overflow."""
    c = int(cfg.parallel.capacity_factor * tokens * cfg.experts_per_token / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def moe_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, object]:
    """Router (d, E), expert SwiGLU weights (E, d, eff) / (E, eff, d), and
    the dense ``fallback`` FFN when ``cfg.parallel.moe_fallback``."""
    d, eff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    p: Dict[str, object] = {
        "router": b.param((d, e), ("embed", None), scale=0.02),
        "w1": b.param((e, d, eff), ("experts", "expert_embed", "expert_mlp")),
        "w3": b.param((e, d, eff), ("experts", "expert_embed", "expert_mlp")),
        "w2": b.param((e, eff, d), ("experts", "expert_mlp", "expert_embed")),
    }
    if cfg.parallel.moe_fallback:
        p["fallback"] = ffn_params(b, d, eff)
    return p


def _expert_ffn(p, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d), a batched SwiGLU over experts."""
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    return torch.bmm(h, p["w2"])


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, tp: Optional[TensorParallel] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), plus the aux values ``moe_aux_loss``,
    ``moe_z_loss``, ``moe_overflow_frac`` and ``moe_load_max``.  With
    ``tp`` (a mesh), ``x`` is this rank's rows in the residual stream's
    layout."""
    if tp is not None:
        return _moe_ffn_sharded(p, x, cfg, tp)
    b, s, d = x.shape
    tokens = b * s
    xt = x.reshape(tokens, d)
    router_logits = xt.float() @ p["router"].float()
    routing = md.route_topk(router_logits, cfg.experts_per_token)
    plan = md.make_dispatch_plan(routing.expert_ids, routing.expert_probs, cfg.num_experts,
                                 moe_capacity(cfg, tokens))

    ye = _expert_ffn(p, md.dispatch(xt, plan))        # expert (accelerator) path
    if cfg.parallel.moe_fallback and "fallback" in p:
        yf = ffn(p["fallback"], x).reshape(tokens, d)  # CC path: dense fallback
    else:
        yf = torch.zeros_like(xt)                      # without the fallback: drop

    out = md.combine(ye, yf, plan).reshape(b, s, d)
    load, overflow = md.expert_load_stats(plan)
    aux = {
        "moe_aux_loss": routing.aux_loss,
        "moe_z_loss": routing.router_z_loss,
        "moe_overflow_frac": overflow,
        "moe_load_max": load.max(),
    }
    return out.to(x.dtype), aux


def _moe_ffn_sharded(p, x: torch.Tensor, cfg: ModelConfig, tp: TensorParallel
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer on a mesh: per-shard routing (``"local"``) or the data
    group's global plan (``"gspmd"``); see the module docstring."""
    local = cfg.parallel.moe_dispatch == "local"
    xin = tp.enter(x)                                # (B, S, d), replicated over model
    if not local:
        xin = gather_seq(xin, tp.data, dim=0)        # every data rank's rows
    b, s, d = xin.shape
    tokens = b * s
    xt = xin.reshape(tokens, d)
    e = cfg.num_experts
    routing = md.route_topk(xt.float() @ tp.shared(p["router"]).float(), cfg.experts_per_token)
    capacity = moe_capacity(cfg, tokens)
    plan = md.make_dispatch_plan(routing.expert_ids, routing.expert_probs, e, capacity)

    e_loc = p["w1"].shape[0]
    if e_loc < e:                                    # expert-parallel: this rank's experts
        lo = tp.rank * e_loc
        sub = plan._replace(slot_token=plan.slot_token[lo:lo + e_loc],
                            slot_valid=plan.slot_valid[lo:lo + e_loc], num_experts=e_loc)
        ye = _place_rows(_expert_ffn(p, md.dispatch(xt, sub)), e, lo)
    else:                                            # every expert, over its expert_mlp block
        ye = _expert_ffn(p, md.dispatch(xt, plan))
    if cfg.parallel.moe_fallback and "fallback" in p:
        yf = ffn(p["fallback"], xt)                  # its mlp block: partial over model
    else:
        yf = torch.zeros_like(xt)
    out = md.combine(ye, yf, plan).reshape(b, s, d).to(x.dtype)
    if not local:                                    # this rank's rows
        rows = b // tp.data.size
        out = out[tp.data.rank * rows:(tp.data.rank + 1) * rows]
    out = tp.leave(out)
    load, overflow = md.expert_load_stats(plan)
    aux = pmean(tp.whole(torch.stack([routing.aux_loss, routing.router_z_loss, overflow,
                                      load.max()])), tp.data)
    return out, dict(zip(("moe_aux_loss", "moe_z_loss", "moe_overflow_frac", "moe_load_max"),
                         aux.unbind()))


def _place_rows(ye: torch.Tensor, total: int, lo: int) -> torch.Tensor:
    """(E_loc, C, d) at row ``lo`` of a zero (E, C, d)."""
    return torch.cat([ye.new_zeros((lo, *ye.shape[1:])), ye,
                      ye.new_zeros((total - lo - ye.shape[0], *ye.shape[1:]))])

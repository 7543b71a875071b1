"""Mixture-of-Experts layer with ENEAC capacity-chunk dispatch.

The port's copy of ``repro.models.moe``.  The routing plan comes from
:mod:`repro_torch.core.moe_dispatch`: experts are the accelerators (a fixed
``capacity`` chunk each), the shared fallback FFN is the CPU-core path
that absorbs the overflow.

The reference has two dispatch strategies (``cfg.parallel.moe_dispatch``):
``"gspmd"``, one global sort-based dispatch, and ``"local"``, per-shard
routing under ``shard_map``, which it takes only when mesh rules are
active and otherwise falls back to the global path.  The port runs on one
device with no mesh rules, so both settings take the global path here; the
shard_map path is slice F's (ROADMAP.md queue 1).  No Pallas kernel is
involved: the batched expert SwiGLU is three batched matrix products.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import moe_dispatch as md
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


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), plus the aux values ``moe_aux_loss``,
    ``moe_z_loss``, ``moe_overflow_frac`` and ``moe_load_max``."""
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

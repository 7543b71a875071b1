"""Feed-forward block: SwiGLU (llama family), as in ``repro.models.ffn``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import ParamBuilder

__all__ = ["ffn_params", "ffn"]


def ffn_params(b: ParamBuilder, d: int, ff: int) -> Dict[str, torch.Tensor]:
    """SwiGLU: gate (w1), up (w3), down (w2)."""
    return {"w1": b.param((d, ff)), "w3": b.param((d, ff)), "w2": b.param((ff, d))}


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]

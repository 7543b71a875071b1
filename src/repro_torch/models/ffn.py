"""Feed-forward blocks, as in ``repro.models.ffn``: SwiGLU (llama family)
and whisper's biased GELU MLP.  ``jax.nn.gelu`` defaults to the tanh
approximation, so :func:`gelu_ffn` uses ``approximate="tanh"``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import ParamBuilder

__all__ = ["ffn_params", "ffn", "gelu_ffn_params", "gelu_ffn"]


def ffn_params(b: ParamBuilder, d: int, ff: int) -> Dict[str, torch.Tensor]:
    """SwiGLU: gate (w1), up (w3), down (w2)."""
    return {"w1": b.param((d, ff), ("embed", "mlp")), "w3": b.param((d, ff), ("embed", "mlp")),
            "w2": b.param((ff, d), ("mlp", "embed"))}


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def gelu_ffn_params(b: ParamBuilder, d: int, ff: int) -> Dict[str, torch.Tensor]:
    return {"w1": b.param((d, ff), ("embed", "mlp")), "b1": b.param((ff,), ("mlp",), init="zeros"),
            "w2": b.param((ff, d), ("mlp", "embed")),
            "b2": b.param((d,), ("embed",), init="zeros")}


def gelu_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]

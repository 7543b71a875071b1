"""Feed-forward blocks, as in ``repro.models.ffn``: SwiGLU (llama family)
and whisper's biased GELU MLP.  ``jax.nn.gelu`` defaults to the tanh
approximation, so :func:`gelu_ffn` uses ``approximate="tanh"``.

On a model axis larger than 1 (``tp``) both are Megatron's pair: ``w1``
/ ``w3`` (and ``b1``) column-parallel over this rank's block of ``mlp``,
``w2`` row-parallel, its partial product leaving through
``reduce_from`` (``scatter_seq`` under sequence parallelism) before
``b2``."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder

__all__ = ["ffn_params", "ffn", "gelu_ffn_params", "gelu_ffn"]


def ffn_params(b: ParamBuilder, d: int, ff: int) -> Dict[str, torch.Tensor]:
    """SwiGLU: gate (w1), up (w3), down (w2)."""
    return {"w1": b.param((d, ff), ("embed", "mlp")), "w3": b.param((d, ff), ("embed", "mlp")),
            "w2": b.param((ff, d), ("mlp", "embed"))}


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
        tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """SwiGLU; with ``tp``, ``x`` in the residual stream's layout."""
    split = tp is not None and tp.size > 1
    if split:
        x = tp.enter(x)
    y = (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    return tp.leave(y) if split else y


def gelu_ffn_params(b: ParamBuilder, d: int, ff: int) -> Dict[str, torch.Tensor]:
    return {"w1": b.param((d, ff), ("embed", "mlp")), "b1": b.param((ff,), ("mlp",), init="zeros"),
            "w2": b.param((ff, d), ("mlp", "embed")),
            "b2": b.param((d,), ("embed",), init="zeros")}


def gelu_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
             tp: Optional[TensorParallel] = None) -> torch.Tensor:
    split = tp is not None and tp.size > 1
    if split:
        x = tp.enter(x)
    y = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"]
    return (tp.leave(y) if split else y) + p["b2"]

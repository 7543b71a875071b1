"""Int8 error-feedback gradient compression for the data-parallel axis.

The port's copy of ``repro.optim.compression``, over the port's trees.
Each leaf is quantized to int8 with a per-tensor scale (symmetric:
max |x| over 127, at least 1e-12 / 127); the quantization error is kept
as a float32 residual and added to the next step's gradient, so the
accumulated update is unbiased (error feedback).  Nothing in the trainer
reads ``ParallelConfig.grad_compression``, as in the reference: this and
``parallel.collectives.compressed_psum`` are library functions.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["CompressionState", "init_state", "abstract_state", "compress", "decompress",
           "ef_compress_tree"]


class CompressionState(NamedTuple):
    residual: Any   # tree like grads (float32 error feedback)


def init_state(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def abstract_state(abstract_params) -> CompressionState:
    """``init_state``'s state over a tree of ``meta`` tensors, as ``meta`` tensors."""
    return CompressionState(residual=tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), abstract_params))


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float → (int8 values, float32 scale).  Symmetric per-tensor quantization."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads, state: CompressionState):
    """Error-feedback quantization of every leaf: (the quantized-and-
    dequantized gradients, ready for the reduction, a new state carrying
    the residuals)."""

    def one(g, r):
        gf = g.float() + r
        deq = decompress(*compress(gf))
        return deq.to(g.dtype), gf - deq

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(state.residual))]
    deq, res = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(deq), grads),
            CompressionState(residual=tree_map(lambda _: next(res), grads)))

"""Pipeline parallelism over one mesh axis: the GPipe schedule.

The port's copy of ``repro.parallel.pipeline``.  Layers split
contiguously over the stages (:func:`stage_partition`: stage s holds
layers [s·L/S, (s+1)·L/S), the remainder front-loaded), and microbatches
stream through the stages with point-to-point hand-offs: cross-stage
traffic is one (B_μ, …) activation per microbatch per boundary.

:func:`pipeline_apply` runs the classic GPipe loop of ``n_micro +
n_stages − 1`` ticks: stage 0 injects microbatch t at tick t, stage s
computes at tick t the microbatch t − s that stage s − 1 handed it at
tick t − 1, and the last stage keeps the outputs, which it then
broadcasts so that every rank returns them.  The reference computes on
every tick and discards a bubble tick's result; the port skips the
bubble ticks, which gives the same outputs.  The port keeps one
parameter dict per layer, so a stage's parameters are a list of its
layers' (the reference scans a stacked leading dim).  As in the
reference, this is a library function: nothing reads
``ParallelConfig.pipeline_stages``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from .collectives import Group

__all__ = ["pipeline_apply", "stage_partition"]


def stage_partition(num_layers: int, num_stages: int) -> List[Tuple[int, int]]:
    """Contiguous layer ranges per stage (front-loaded remainder)."""
    base, rem = divmod(num_layers, num_stages)
    out = []
    start = 0
    for s in range(num_stages):
        n = base + (1 if s < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def pipeline_apply(stage_params: Sequence, x_micro: torch.Tensor, layer_fn: Callable,
                   group: Group) -> torch.Tensor:
    """This stage's layers (``stage_params``, one entry per layer, in
    order; the stage is this rank's place in ``group``) applied in the
    GPipe schedule to ``x_micro`` (n_micro, B_μ, …), the same on every
    rank; ``layer_fn(params, x) -> x`` keeps x's shape and dtype.  Returns
    the last stage's (n_micro, B_μ, …) outputs on every rank."""
    n_stages, stage = group.size, group.rank
    n_micro = x_micro.shape[0]
    buf = torch.empty_like(x_micro[0])               # inter-stage register
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        m = t - stage                                # this stage's microbatch at tick t
        if not 0 <= m < n_micro:
            continue                                 # a bubble tick
        x = x_micro[m] if stage == 0 else group.recv(buf, stage - 1)
        for p in stage_params:
            x = layer_fn(p, x)
        if stage < n_stages - 1:
            group.send(x, stage + 1)
        else:
            outs[m] = x
    return group.broadcast(outs, n_stages - 1)

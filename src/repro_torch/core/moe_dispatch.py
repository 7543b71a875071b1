"""ENEAC-style Mixture-of-Experts dispatch: capacity chunks + dense fallback.

The port's copy of ``repro.core.moe_dispatch``.  Token→expert routing is
an irregular iteration space (expert loads are data-dependent, as in the
paper's SPMM), mapped onto the paper's units:

* **Experts = accelerators (ACC).**  Each expert processes a fixed-size
  chunk of at most ``capacity`` tokens per step: the ACC chunk size.
* **Dense fallback path = the CPU cores (CC).**  Tokens that overflow an
  expert's capacity are not dropped; a shared dense FFN picks them up with
  their router weight.
* **MultiDynamic = the capacity controller.**  :class:`CapacityController`
  adapts the capacity factor between steps from the realized load.

Dispatch is sort-based (a stable argsort by expert id gives each
assignment its rank within its expert, in token order), never a dense
``(T, E, C)`` one-hot.  Both directions are gathers, and the combine is a
reshape-sum: the assignments of token ``t`` are rows ``t·k .. t·k+k−1``.

Two places where PyTorch's defaults differ from ``jax.lax``: ``top_k``
gives the lower expert index on a tie, which ``torch.topk`` does not
promise, so :func:`route_topk` takes the first ``k`` of a stable
descending sort; and the rank within an expert comes from
``torch.argsort(..., stable=True)``, as in the reference.  Index tensors
are int64, PyTorch's index dtype (the reference's are int32).  The
reference's ``shard_hint`` annotations have no counterpart: on a mesh
``models/moe.py`` hands these functions one rank's tokens (or its data
group's) and the slots of its experts, and runs the collectives itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "RouterOutput",
    "DispatchPlan",
    "route_topk",
    "make_dispatch_plan",
    "dispatch",
    "combine",
    "CapacityController",
    "expert_load_stats",
]


class RouterOutput(NamedTuple):
    expert_ids: torch.Tensor     # (T, k) int64: chosen experts per token
    expert_probs: torch.Tensor   # (T, k) float32: router weights (softmax'd)
    router_z_loss: torch.Tensor  # scalar: router logit regularizer
    aux_loss: torch.Tensor       # scalar: load-balance auxiliary loss


class DispatchPlan(NamedTuple):
    """Static-shape routing plan for one MoE layer application."""

    slot_token: torch.Tensor     # (E, C) int64: token feeding each slot (T = empty)
    slot_valid: torch.Tensor     # (E, C) bool: slot actually filled
    slot_index: torch.Tensor     # (T*k,) int64 in [0, E*C) or -1 (overflow)
    expert_ids: torch.Tensor     # (T, k)
    gate: torch.Tensor           # (T, k) float: combine weights
    overflow: torch.Tensor       # (T, k) bool: True => served by the fallback path
    num_experts: int
    capacity: int


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids in [0, n), without the
    device-to-host read of ``ids.max()`` that ``torch.bincount`` makes on a
    CUDA tensor (a sync per call)."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def route_topk(
    logits: torch.Tensor,
    k: int,
    *,
    router_noise: Optional[torch.Tensor] = None,
    norm_topk: bool = True,
) -> RouterOutput:
    """Top-k routing with the standard auxiliary losses.

    ``logits``: (T, E) raw router outputs.  ``norm_topk`` renormalizes the
    chosen probabilities to sum to 1 per token (Qwen3/Mixtral convention).
    Ties go to the lower expert index, as with ``jax.lax.top_k``.
    """
    _, num_experts = logits.shape
    if router_noise is not None:
        logits = logits + router_noise
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    expert_probs, expert_ids = sorted_probs[:, :k], order[:, :k]
    if norm_topk:
        expert_probs = expert_probs / torch.clamp(expert_probs.sum(dim=-1, keepdim=True),
                                                  min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = _counts(expert_ids[:, 0], num_experts).float() / logits.shape[0]
    p = probs.mean(dim=0)
    aux = num_experts * torch.sum(f * p)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return RouterOutput(expert_ids, expert_probs, z, aux)


def make_dispatch_plan(
    expert_ids: torch.Tensor,
    expert_probs: torch.Tensor,
    num_experts: int,
    capacity: int,
) -> DispatchPlan:
    """Sort-based capacity assignment (the MultiDynamic chunk issue).

    Every (token, k) assignment gets a rank within its expert (arrival
    order = token order, the paper's in-order chunk issue); ranks at or
    past ``capacity`` overflow to the fallback path.
    """
    tokens, k = expert_ids.shape
    n, cap = tokens * k, capacity
    device = expert_ids.device
    flat_expert = expert_ids.reshape(-1).long()                  # (T*k,)

    # rank within expert: stable sort by expert id, then position − segment start
    order = torch.argsort(flat_expert, stable=True)
    counts = _counts(flat_expert, num_experts)                   # (E,)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_sorted = torch.arange(n, device=device) - starts[flat_expert[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted                                       # undo the sort

    overflow_flat = pos >= cap
    slot = torch.where(overflow_flat, torch.full_like(pos, -1), flat_expert * cap + pos)

    # slot -> assignment table (E, C): slot (e, c) holds the c-th sorted
    # assignment of expert e
    grid = starts[:, None] + torch.arange(cap, device=device)[None, :]
    slot_valid = torch.arange(cap, device=device)[None, :] < torch.clamp(counts, max=cap)[:, None]
    assign = order[torch.clamp(grid, 0, n - 1)]                   # (E, C) in [0, T*k)
    slot_token = torch.where(slot_valid, assign // k, torch.full_like(assign, tokens))
    return DispatchPlan(
        slot_token=slot_token,
        slot_valid=slot_valid,
        slot_index=slot,
        expert_ids=expert_ids,
        gate=expert_probs,
        overflow=overflow_flat.reshape(tokens, k),
        num_experts=num_experts,
        capacity=cap,
    )


def dispatch(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Gather tokens into their expert chunks: (T, d) -> (E, C, d)."""
    safe = torch.clamp(plan.slot_token, 0, x.shape[0] - 1)
    xe = x[safe]                                                  # (E, C, d)
    return torch.where(plan.slot_valid[..., None], xe, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def combine(
    expert_out: torch.Tensor,     # (E, C, d): ACC path results
    fallback_out: torch.Tensor,   # (T, d): CC path results (dense FFN)
    plan: DispatchPlan,
) -> torch.Tensor:
    """Weighted merge back to token order (ENEAC result merge).

    Each assignment contributes ``gate · expert_out`` if it ran on its
    expert, else ``gate · fallback_out``: the CC path picks up exactly the
    overflowed fraction with its router weight.  Assignments of token t are
    rows t·k .. t·k+k−1, so the reduction is a reshape-sum.
    """
    cap, d = expert_out.shape[1], expert_out.shape[2]
    tokens, k = plan.gate.shape
    flat_gate = plan.gate.reshape(-1).to(expert_out.dtype)        # (T*k,)
    safe_slot = torch.clamp(plan.slot_index, min=0)
    picked = expert_out[safe_slot // cap, safe_slot % cap]        # (T*k, d)
    overflow = plan.overflow.reshape(-1)
    fb = torch.repeat_interleave(fallback_out, k, dim=0) if k > 1 else fallback_out
    contrib = torch.where(overflow[:, None], fb, picked) * flat_gate[:, None]
    return contrib.reshape(tokens, k, d).sum(dim=1)


def expert_load_stats(plan: DispatchPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-expert load as a fraction of capacity, overflow fraction): the
    runtime feedback that drives :class:`CapacityController`."""
    counts = _counts(plan.expert_ids, plan.num_experts)
    load = counts.float() / float(plan.capacity)
    overflow_frac = plan.overflow.float().mean()
    return load, overflow_frac


@dataclasses.dataclass
class CapacityController:
    """Host-side MultiDynamic controller for the capacity factor.

    If the overflow fraction (work sent to the slow CC path) exceeds
    ``target_overflow`` the capacity factor grows; if experts run underfull
    (padding waste, the Table-1 cliff) it shrinks.  Changes are quantized
    to ``quantum`` so the static capacity only changes on material shifts.
    """

    capacity_factor: float = 1.25
    target_overflow: float = 0.02
    min_factor: float = 1.0
    max_factor: float = 4.0
    gain: float = 0.5
    quantum: float = 0.25

    def capacity(self, tokens: int, k: int, num_experts: int) -> int:
        c = int(self.capacity_factor * tokens * k / num_experts)
        return max(1, c)

    def update(self, overflow_frac: float, mean_load: float) -> bool:
        """Feed realized stats; returns True if the factor changed (the
        caller should then use the new static capacity)."""
        old = self.capacity_factor
        if overflow_frac > self.target_overflow:
            self.capacity_factor *= 1.0 + self.gain * min(overflow_frac, 0.5)
        elif mean_load < 0.5:  # under-full: padding waste
            self.capacity_factor *= 1.0 - self.gain * 0.25
        self.capacity_factor = min(self.max_factor, max(self.min_factor, self.capacity_factor))
        # quantize for hysteresis
        self.capacity_factor = round(self.capacity_factor / self.quantum) * self.quantum
        return self.capacity_factor != old

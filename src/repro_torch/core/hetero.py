"""Heterogeneous throughput modelling and work partitioning.

At pod scale the ENEAC "CC vs ACC" split becomes *data-parallel groups of
unequal throughput*: mixed TPU generations, thermally throttled hosts, or
transient stragglers.  SPMD lock-step means every collective waits for the
slowest group, so the only lever is the one the paper identifies: give each
unit an amount of work proportional to its measured throughput so that all
units finish a step at the same time.

The iteration space is the step's *microbatches* (gradient-accumulation
chunks — the direct analogue of the paper's iteration chunks): each group
runs ``k_g`` microbatches of a fixed shape (fixed shape ⇒ one compiled
executable, no recompile churn) and contributes gradients weighted by the
tokens it actually processed, keeping the global gradient unbiased.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = ["ThroughputTracker", "HeteroPartition", "HeterogeneousPartitioner"]


class ThroughputTracker:
    """EWMA throughput per group — the runtime feedback of MultiDynamic."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = alpha
        self._tp: Dict[str, float] = {}

    def update(self, group: str, items: float, elapsed: float) -> float:
        inst = items / max(elapsed, 1e-12)
        prev = self._tp.get(group)
        self._tp[group] = inst if prev is None else self.alpha * inst + (1 - self.alpha) * prev
        return self._tp[group]

    def get(self, group: str, default: float = 1.0) -> float:
        return self._tp.get(group, default)

    def snapshot(self) -> Dict[str, float]:
        return dict(self._tp)


@dataclass(frozen=True)
class HeteroPartition:
    """An integer split of ``total_microbatches`` across groups."""

    counts: Dict[str, int]
    # gradient weight per group = fraction of total tokens it processed;
    # used to de-bias the gradient average when counts differ.
    weights: Dict[str, float]

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def max_over_min(self) -> float:
        vals = [v for v in self.counts.values() if v > 0]
        return max(vals) / min(vals) if vals else 1.0


class HeterogeneousPartitioner:
    """Throughput-proportional integer partition with hysteresis.

    * proportional share via the largest-remainder (Hamilton) method so the
      counts always sum exactly to ``total``;
    * every healthy group gets at least ``min_per_group`` (a group with 0
      microbatches would idle through the collectives anyway);
    * hysteresis: a new partition is only adopted if some group's count
      changes by more than ``rebalance_threshold`` (relative), avoiding
      flapping from throughput noise — the scheduling analogue of the
      paper's observation that chunk-size churn hurts regular workloads.
    """

    def __init__(
        self,
        *,
        min_per_group: int = 1,
        rebalance_threshold: float = 0.25,
    ) -> None:
        self.min_per_group = min_per_group
        self.rebalance_threshold = rebalance_threshold
        self._current: Optional[HeteroPartition] = None

    # -- pure computation ------------------------------------------------
    def proportional(self, total: int, throughputs: Dict[str, float]) -> HeteroPartition:
        groups = sorted(throughputs)
        n = len(groups)
        if n == 0:
            raise ValueError("no groups")
        if total < n * self.min_per_group:
            raise ValueError(
                f"total={total} microbatches cannot give {n} groups "
                f">= {self.min_per_group} each"
            )
        tsum = sum(max(throughputs[g], 1e-12) for g in groups)
        # Reserve the minimum, distribute the rest proportionally.
        reserve = n * self.min_per_group
        spare = total - reserve
        quotas = {g: spare * max(throughputs[g], 1e-12) / tsum for g in groups}
        counts = {g: self.min_per_group + int(math.floor(quotas[g])) for g in groups}
        leftover = total - sum(counts.values())
        # Largest remainder
        remainders = sorted(groups, key=lambda g: quotas[g] - math.floor(quotas[g]), reverse=True)
        for g in remainders[:leftover]:
            counts[g] += 1
        weights = {g: counts[g] / total for g in groups}
        return HeteroPartition(counts=counts, weights=weights)

    # -- stateful with hysteresis -----------------------------------------
    def update(self, total: int, throughputs: Dict[str, float]) -> HeteroPartition:
        proposed = self.proportional(total, throughputs)
        if self._current is None or set(self._current.counts) != set(proposed.counts):
            self._current = proposed
            return proposed
        # adopt only if materially different
        for g, new in proposed.counts.items():
            old = self._current.counts[g]
            if old == 0 or abs(new - old) / max(old, 1) > self.rebalance_threshold:
                self._current = proposed
                return proposed
        return self._current

    @property
    def current(self) -> Optional[HeteroPartition]:
        return self._current

    # -- analysis ----------------------------------------------------------
    @staticmethod
    def step_time(partition: HeteroPartition, throughputs: Dict[str, float]) -> float:
        """Predicted step wall time = slowest group's time (SPMD lock-step)."""
        return max(
            partition.counts[g] / max(throughputs.get(g, 1e-12), 1e-12)
            for g in partition.counts
        )

    @staticmethod
    def uniform(total: int, groups: Sequence[str]) -> HeteroPartition:
        """The homogeneous baseline every framework ships."""
        n = len(groups)
        base = total // n
        rem = total % n
        counts = {g: base + (1 if i < rem else 0) for i, g in enumerate(sorted(groups))}
        weights = {g: counts[g] / total for g in counts}
        return HeteroPartition(counts=counts, weights=weights)

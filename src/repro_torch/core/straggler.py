"""Straggler detection and mitigation.

On 1000+ node jobs some hosts are always slow (thermal throttling, ECC
retries, noisy neighbours, failing NICs).  SPMD lock-step turns one slow
group into a whole-job slowdown.  The ENEAC response: measure per-unit
throughput at runtime and rebalance the chunk assignment (here: per-group
microbatch counts via :class:`~repro.core.hetero.HeterogeneousPartitioner`).

Detection is deliberately boring and robust: per-group step-time EWMA
compared against the fleet median with a multiplicative threshold plus a
consecutive-breach count (single slow steps — GC pauses, checkpoint writes —
must not trigger a rebalance).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .hetero import HeteroPartition, HeterogeneousPartitioner, ThroughputTracker

__all__ = ["StragglerDetector", "StragglerReport", "MitigationPlan", "StragglerMitigator"]


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclass
class StragglerReport:
    stragglers: List[str]
    ratios: Dict[str, float]          # group step time / median step time
    median_step_time: float


@dataclass
class MitigationPlan:
    partition: HeteroPartition
    predicted_step_time: float
    baseline_step_time: float

    @property
    def predicted_speedup(self) -> float:
        return self.baseline_step_time / max(self.predicted_step_time, 1e-12)


class StragglerDetector:
    def __init__(
        self,
        *,
        alpha: float = 0.3,
        threshold: float = 1.3,
        patience: int = 3,
    ) -> None:
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self._ewma: Dict[str, float] = {}
        self._breaches: Dict[str, int] = {}

    def observe(self, step_times: Dict[str, float]) -> StragglerReport:
        for g, t in step_times.items():
            prev = self._ewma.get(g)
            self._ewma[g] = t if prev is None else self.alpha * t + (1 - self.alpha) * prev
        med = _median(list(self._ewma.values()))
        ratios = {g: v / max(med, 1e-12) for g, v in self._ewma.items()}
        stragglers = []
        # Breach counters move only for groups observed *this* call: the
        # engine feeds one completion at a time, and a unit must not
        # accumulate breaches while it is idle just because others finish.
        for g in step_times:
            if ratios.get(g, 0.0) > self.threshold:
                self._breaches[g] = self._breaches.get(g, 0) + 1
            else:
                self._breaches[g] = 0
        for g, n in self._breaches.items():
            if n >= self.patience:
                stragglers.append(g)
        return StragglerReport(stragglers=sorted(stragglers), ratios=ratios, median_step_time=med)

    def forget(self, group: str) -> None:
        """Stop tracking ``group`` (e.g. after it was quarantined) so its
        stale EWMA no longer skews the fleet median."""
        self._ewma.pop(group, None)
        self._breaches.pop(group, None)


class StragglerMitigator:
    """Glue: detector + throughput tracker + partitioner → MitigationPlan."""

    def __init__(
        self,
        groups: Sequence[str],
        total_microbatches: int,
        *,
        detector: Optional[StragglerDetector] = None,
        partitioner: Optional[HeterogeneousPartitioner] = None,
    ) -> None:
        self.groups = list(groups)
        self.total = total_microbatches
        self.detector = detector or StragglerDetector()
        self.partitioner = partitioner or HeterogeneousPartitioner()
        self.tracker = ThroughputTracker()
        self.partition = HeterogeneousPartitioner.uniform(total_microbatches, groups)

    def step(self, step_times: Dict[str, float]) -> Optional[MitigationPlan]:
        """Feed one step's per-group times; returns a plan when rebalancing."""
        for g, t in step_times.items():
            self.tracker.update(g, items=self.partition.counts[g], elapsed=t)
        report = self.detector.observe(step_times)
        if not report.stragglers:
            return None
        tps = {g: self.tracker.get(g) for g in self.groups}
        new = self.partitioner.update(self.total, tps)
        if new is self.partition:
            return None
        baseline = HeterogeneousPartitioner.step_time(
            HeterogeneousPartitioner.uniform(self.total, self.groups), tps
        )
        plan = MitigationPlan(
            partition=new,
            predicted_step_time=HeterogeneousPartitioner.step_time(new, tps),
            baseline_step_time=baseline,
        )
        self.partition = new
        return plan

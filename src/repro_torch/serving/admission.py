"""Admission policies and backpressure for the serving tier.

The port's copy of ``repro.serving.admission`` (which imports no jax), on
the port's own ``core.hetero`` and ``core.straggler``.

The paper's scheduler argument — *which* unit gets the next chunk should
follow measured completion behaviour, not a fixed plan — translates at
the serving tier into *which request* gets the next free decode slot.
This module makes that decision pluggable:

* :class:`FIFOPolicy` — arrival order (the pre-PR-6 behaviour, and the
  baseline every other policy is benchmarked against).
* :class:`PriorityPolicy` — strict priority classes, FIFO within a
  class (``Request.priority``, higher first).
* :class:`DeadlinePolicy` — earliest-deadline-first over per-request
  SLOs (``Request.deadline``, relative seconds from submit); requests
  whose budget is already spent at admission time are shed instead of
  wasting prefill work.
* :class:`CostAwarePolicy` — shortest-predicted-prefill-first: the
  predicted cost of a request is ``prompt_len / throughput`` where
  throughput is an online :class:`~repro_torch.core.hetero.ThroughputTracker`
  EWMA learned from observed prefill completions (the MultiDynamic
  feedback rule applied to request routing).  A
  :class:`~repro_torch.core.straggler.StragglerDetector` watches per-slot
  prefill time per token, so persistently slow prefill units are
  visible to callers (``straggler_report``).

Every policy also owns the **backpressure** verdict: ``admit`` is
consulted by :meth:`ServingEngine.submit` *before* a request enters the
queue and returns an :class:`AdmissionVerdict` — a bounded queue
(``max_queue``) sheds instead of growing without limit, which is what
keeps an open-loop arrival process from driving latency to infinity.

Ordering is applied when the engine snapshots its queue into a
scheduler feed: ``order(requests, now)`` returns the snapshot sequence,
and the runtime's completion-driven ``WorkQueue`` then serves it
front-to-back as slots free up.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

from ..core.hetero import ThroughputTracker
from ..core.straggler import StragglerDetector, StragglerReport

__all__ = [
    "AdmissionVerdict",
    "AdmissionPolicy",
    "FIFOPolicy",
    "PriorityPolicy",
    "DeadlinePolicy",
    "CostAwarePolicy",
    "POLICIES",
    "make_policy",
]


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """The result of offering a request to the serving tier.

    Truthy iff admitted, so callers can write ``if not engine.submit(r)``.
    ``reason`` names the shed cause (``"queue_full"``, ``"expired"``) or
    ``"admitted"``; ``queue_depth`` is the depth observed at decision
    time (post-admission depth for admitted requests).
    """

    admitted: bool
    reason: str = "admitted"
    queue_depth: int = 0

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionPolicy:
    """Base policy: unbounded FIFO.  Subclasses override the hooks.

    ``max_queue`` bounds the engine queue: an arrival that would push
    the depth past it is shed with ``reason="queue_full"`` — the
    backpressure contract every subclass inherits.
    """

    name = "fifo"

    def __init__(self, *, max_queue: Optional[int] = None) -> None:
        if max_queue is not None and max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self.max_queue = max_queue

    # -- backpressure --------------------------------------------------------
    def admit(self, req, *, queue_depth: int, now: float) -> AdmissionVerdict:
        if self.max_queue is not None and queue_depth >= self.max_queue:
            return AdmissionVerdict(False, "queue_full", queue_depth)
        return AdmissionVerdict(True, "admitted", queue_depth + 1)

    # -- snapshot ordering -----------------------------------------------------
    def order(self, requests: Sequence, *, now: float = 0.0) -> List:
        """Return the feed order for a queue snapshot (front served first)."""
        return list(requests)

    # -- cost feedback (no-op unless a policy learns online) -----------------
    def observe_prefill(self, unit: str, tokens: int, elapsed: float) -> None:
        """Engine callback: one finished prefill of ``tokens`` prompt
        tokens took ``elapsed`` seconds on ``unit``."""

    def describe(self) -> str:
        bound = f", max_queue={self.max_queue}" if self.max_queue else ""
        return f"{type(self).__name__}({self.name!r}{bound})"


class FIFOPolicy(AdmissionPolicy):
    """Arrival order — the baseline."""

    name = "fifo"


class PriorityPolicy(AdmissionPolicy):
    """Strict priority classes; FIFO within a class.

    ``Request.priority`` is an int, higher served first.  The sort is
    stable, so equal-priority requests keep their arrival order.
    """

    name = "priority"

    def order(self, requests: Sequence, *, now: float = 0.0) -> List:
        return sorted(requests, key=lambda r: -int(getattr(r, "priority", 0)))


class DeadlinePolicy(AdmissionPolicy):
    """Earliest-deadline-first over per-request SLOs.

    ``Request.deadline`` is a *relative* budget in seconds from submit;
    the engine stamps ``Request.submitted_at``, so the absolute deadline
    is ``submitted_at + deadline``.  Requests without a deadline sort
    after every deadlined one (best-effort class).  An arrival whose
    budget is already spent (``now >= submitted-at-deadline``, which at
    admit time means ``deadline <= 0``) is shed as ``"expired"`` rather
    than admitted to miss.
    """

    name = "deadline"

    @staticmethod
    def _absolute(req, now: float) -> float:
        rel = getattr(req, "deadline", None)
        if rel is None:
            return float("inf")
        base = getattr(req, "submitted_at", None)
        return (base if base is not None else now) + rel

    def admit(self, req, *, queue_depth: int, now: float) -> AdmissionVerdict:
        verdict = super().admit(req, queue_depth=queue_depth, now=now)
        if not verdict:
            return verdict
        rel = getattr(req, "deadline", None)
        if rel is not None and rel <= 0:
            return AdmissionVerdict(False, "expired", queue_depth)
        return verdict

    def order(self, requests: Sequence, *, now: float = 0.0) -> List:
        return sorted(requests, key=lambda r: self._absolute(r, now))


class CostAwarePolicy(AdmissionPolicy):
    """Shortest-predicted-prefill-first from measured throughput.

    Prediction: ``len(prompt) / tp`` where ``tp`` is the EWMA prefill
    throughput (prompt tokens per second) learned from
    :meth:`observe_prefill` — before any observation the tracker default
    makes this plain shortest-prompt-first.  Per-slot observations also
    feed a :class:`~repro_torch.core.straggler.StragglerDetector` on prefill
    seconds-per-token, so a persistently slow prefill unit (a thermally
    throttled core, a congested remote worker) is reported rather than
    silently averaged away.

    Pass ``cost_model=`` (a :class:`~repro_torch.core.costmodel.CostModel`) to
    share capability descriptors with the batch runtime: prefill
    observations land in the model under ``kernel`` (default
    ``"prefill"``) and predictions use its persisted fleet throughput
    when available — a restarted server starts cost-aware instead of
    shortest-prompt-first.
    """

    name = "cost"

    def __init__(
        self,
        *,
        max_queue: Optional[int] = None,
        tracker: Optional[ThroughputTracker] = None,
        detector: Optional[StragglerDetector] = None,
        cost_model=None,
        kernel: str = "prefill",
    ) -> None:
        super().__init__(max_queue=max_queue)
        self.tracker = tracker or ThroughputTracker()
        self.detector = detector or StragglerDetector()
        self.straggler_report: Optional[StragglerReport] = None
        # Optional shared repro_torch.core.costmodel.CostModel: the same store a
        # HeteroRuntime learns batch splits from.  Observations flow both
        # ways — prefills teach it under ``kernel``, predictions prefer
        # its fleet throughput over the policy-local tracker, and the
        # model's persistence means a restarted server predicts from day
        # one instead of re-warming.
        self.cost_model = cost_model
        self.kernel = kernel

    def observe_prefill(self, unit: str, tokens: int, elapsed: float) -> None:
        tokens = max(int(tokens), 1)
        self.tracker.update("prefill", tokens, elapsed)
        self.tracker.update(unit, tokens, elapsed)
        if self.cost_model is not None:
            self.cost_model.observe(unit, self.kernel,
                                    items=tokens, elapsed=elapsed)
        self.straggler_report = self.detector.observe(
            {unit: elapsed / tokens}
        )

    def predicted_cost(self, req) -> float:
        tp = None
        if self.cost_model is not None:
            tp = self.cost_model.fleet_throughput(self.kernel)
        if tp is None:
            tp = self.tracker.get("prefill", 1.0)
        return len(req.prompt) / tp

    def order(self, requests: Sequence, *, now: float = 0.0) -> List:
        return sorted(requests, key=self.predicted_cost)


POLICIES: Dict[str, type] = {
    "fifo": FIFOPolicy,
    "priority": PriorityPolicy,
    "deadline": DeadlinePolicy,
    "cost": CostAwarePolicy,
}


def make_policy(
    spec: Union[str, AdmissionPolicy, None],
    *,
    max_queue: Optional[int] = None,
) -> AdmissionPolicy:
    """Normalize a policy spec (name / instance / None) to a policy.

    ``None`` means FIFO.  Passing ``max_queue`` alongside an *instance*
    whose bound is unset installs the bound on it; conflicting explicit
    bounds are an error (two sources of truth).
    """
    if isinstance(spec, AdmissionPolicy):
        if max_queue is not None:
            if spec.max_queue is not None and spec.max_queue != max_queue:
                raise ValueError(
                    f"policy already bounds its queue at {spec.max_queue}, "
                    f"conflicting max_queue={max_queue}"
                )
            spec.max_queue = max_queue
        return spec
    if spec is None:
        return FIFOPolicy(max_queue=max_queue)
    cls = POLICIES.get(str(spec))
    if cls is None:
        raise ValueError(
            f"unknown admission policy {spec!r}: valid names are "
            + ", ".join(sorted(POLICIES))
            + ", or an AdmissionPolicy instance"
        )
    return cls(max_queue=max_queue)

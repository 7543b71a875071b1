"""Serving: the continuous-batching engine (ENEAC completion-driven refill),
admission policies with backpressure, and sampling.

The open-loop load harness (``repro.serving.loadgen``) is not ported yet
(ROADMAP.md queue 1 item 11).
"""

from .admission import (
    AdmissionPolicy,
    AdmissionVerdict,
    CostAwarePolicy,
    DeadlinePolicy,
    FIFOPolicy,
    PriorityPolicy,
    make_policy,
)
from .engine import Request, RequestResult, ServingEngine
from .sampling import sample

__all__ = [
    "AdmissionPolicy",
    "AdmissionVerdict",
    "CostAwarePolicy",
    "DeadlinePolicy",
    "FIFOPolicy",
    "PriorityPolicy",
    "Request",
    "RequestResult",
    "ServingEngine",
    "make_policy",
    "sample",
]

"""Serving: the continuous-batching engine (ENEAC completion-driven refill,
prefill inline, on threads or in remote worker processes), admission
policies with backpressure, sampling, and the open-loop load harness."""

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
from .loadgen import LoadgenScenario, TimedRequest, make_trace, run_trace
from .sampling import sample

__all__ = [
    "AdmissionPolicy",
    "AdmissionVerdict",
    "CostAwarePolicy",
    "DeadlinePolicy",
    "FIFOPolicy",
    "PriorityPolicy",
    "LoadgenScenario",
    "Request",
    "RequestResult",
    "ServingEngine",
    "TimedRequest",
    "make_trace",
    "run_trace",
    "make_policy",
    "sample",
]

"""Open-loop load generation for the serving tier.

The port's copy of ``repro.serving.loadgen``: the same scenario gives the
same trace (arrival times, prompts, lengths, priorities, deadlines) in
both packages.

The paper's claim is about *irregular* workloads; a serving benchmark
only exposes it if the traffic is irregular too.  This module builds
seeded request traces with controllable irregularity and drives a
:class:`~repro_torch.serving.engine.ServingEngine` with them **open-loop**:
arrivals happen at trace-determined times whether or not the engine has
kept up (the only honest way to measure tail latency — a closed loop
slows its own arrivals exactly when the engine struggles, hiding the
tail).  E2C's workload-scenario simulator (arXiv:2212.11333) is the
model: mixed arrival processes × mixed length distributions are what
separate schedulers that look identical under uniform load.

* **Arrivals** — ``"poisson"`` (exponential inter-arrival gaps at
  ``rate`` req/s), ``"bursty"`` (on/off modulated Poisson: short dense
  bursts separated by quiet gaps, same mean rate), or ``"uniform"``
  (constant gap control).
* **Lengths** — prompt and generation lengths drawn from a clipped Zipf
  (``zipf_a``): mostly short, occasionally very long — the mixed-length
  scenario where continuous batching beats static refill.
* **Deadlines** — optional per-request SLO ``deadline_base +
  deadline_per_token * max_new_tokens`` seconds, so *goodput* (tokens of
  requests that met their deadline) is measurable, not assumed.

``run_trace`` returns a stable metrics dict (p50/p95/p99 latency, TTFT,
goodput, shed/failed counts) — the reference's schema, which its serving
benchmark commits to ``BENCH_serving.json``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import Request, ServingEngine

__all__ = [
    "LoadgenScenario",
    "TimedRequest",
    "make_trace",
    "run_trace",
    "summarize",
    "METRIC_KEYS",
]

ARRIVALS = ("poisson", "bursty", "uniform")

# The stable schema of run_trace()/summarize(), the reference's.
METRIC_KEYS = (
    "requests", "completed", "failed", "shed",
    "wall_time_s", "tokens",
    "mean_latency_s", "p50_latency_s", "p95_latency_s", "p99_latency_s",
    "mean_ttft_s", "p95_ttft_s",
    "tokens_per_s", "goodput_tokens", "goodput_tokens_per_s",
    "deadline_hit_rate",
)


@dataclasses.dataclass(frozen=True)
class LoadgenScenario:
    """A fully-seeded description of one traffic pattern."""

    name: str = "mixed"
    seed: int = 0
    n: int = 32
    rate: float = 50.0                 # mean arrivals per second
    arrival: str = "poisson"           # poisson | bursty | uniform
    prompt_lens: Tuple[int, int] = (2, 48)   # clipped-Zipf bounds
    gen_lens: Tuple[int, int] = (2, 48)
    zipf_a: float = 1.4
    vocab_size: int = 256
    deadline_base: Optional[float] = None     # seconds; None = no SLO
    deadline_per_token: float = 0.0
    priorities: Tuple[int, ...] = (0,)        # cycled over arrivals
    burst_factor: float = 8.0          # bursty: in-burst rate multiplier

    def describe(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TimedRequest:
    """One trace entry: the request and its arrival offset (seconds)."""

    at: float
    request: Request


def _zipf_clipped(rng: np.random.Generator, n: int, a: float,
                  lo: int, hi: int) -> np.ndarray:
    """Zipf ranks mapped into [lo, hi]: mass at lo, heavy tail to hi."""
    raw = rng.zipf(a, size=n)
    return np.clip(lo + raw - 1, lo, hi).astype(np.int64)


def _arrival_times(rng: np.random.Generator, sc: LoadgenScenario) -> np.ndarray:
    if sc.arrival not in ARRIVALS:
        raise ValueError(
            f"unknown arrival process {sc.arrival!r} (want one of {ARRIVALS})"
        )
    if sc.arrival == "uniform":
        gaps = np.full(sc.n, 1.0 / sc.rate)
    elif sc.arrival == "poisson":
        gaps = rng.exponential(1.0 / sc.rate, size=sc.n)
    else:  # bursty: on/off modulated Poisson, same mean rate
        gaps = np.empty(sc.n)
        i = 0
        while i < sc.n:
            burst = int(rng.integers(2, 9))          # arrivals per burst
            # the first arrival of a burst waits out the quiet period
            gaps[i] = rng.exponential(sc.burst_factor / (2.0 * sc.rate))
            i += 1
            for _ in range(min(burst - 1, sc.n - i)):
                gaps[i] = rng.exponential(1.0 / (sc.rate * sc.burst_factor))
                i += 1
    return np.cumsum(gaps)


def make_trace(
    scenario: Optional[LoadgenScenario] = None, **overrides
) -> List[TimedRequest]:
    """Build a seeded open-loop trace.

    Pass a :class:`LoadgenScenario` or keyword overrides of its fields
    (``make_trace(seed=1, n=64, arrival="bursty")``).  The same scenario
    always yields the same trace — arrival times, prompts, lengths,
    priorities, and deadlines are all drawn from one seeded generator.
    """
    if scenario is None:
        scenario = LoadgenScenario(**overrides)
    elif overrides:
        scenario = dataclasses.replace(scenario, **overrides)
    sc = scenario
    rng = np.random.default_rng(sc.seed)
    at = _arrival_times(rng, sc)
    plens = _zipf_clipped(rng, sc.n, sc.zipf_a, *sc.prompt_lens)
    glens = _zipf_clipped(rng, sc.n, sc.zipf_a, *sc.gen_lens)
    trace: List[TimedRequest] = []
    for i in range(sc.n):
        prompt = rng.integers(0, sc.vocab_size, int(plens[i])).astype(np.int32)
        deadline = None
        if sc.deadline_base is not None:
            deadline = sc.deadline_base + sc.deadline_per_token * int(glens[i])
        trace.append(TimedRequest(
            at=float(at[i]),
            request=Request(
                rid=i, prompt=prompt, max_new_tokens=int(glens[i]),
                priority=int(sc.priorities[i % len(sc.priorities)]),
                deadline=deadline,
            ),
        ))
    return trace


def _pct(xs: Sequence[float], p: float) -> float:
    # nan, not 0.0: a run that completed nothing has *no* latency
    # distribution, and a 0.0s p99 reads as an impossibly good pass.
    return float(np.percentile(list(xs), p)) if len(xs) else float("nan")


def summarize(engine: ServingEngine, *, wall: float,
              offered: int) -> Dict[str, float]:
    """Fold an engine's results into the stable ``METRIC_KEYS`` schema."""
    results = list(engine.results.values())
    done = [r for r in results if r.error is None]
    lats = [r.latency for r in done]
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tokens = sum(len(r.tokens) for r in done)
    good = sum(len(r.tokens) for r in done if r.met_deadline)
    with_slo = [r for r in done if r.deadline is not None]
    hits = sum(1 for r in with_slo if r.met_deadline)
    wall = max(wall, 1e-9)
    return {
        "requests": offered,
        "completed": len(done),
        "failed": len(results) - len(done),
        "shed": len(engine.shed),
        "wall_time_s": wall,
        "tokens": tokens,
        "mean_latency_s": float(np.mean(lats)) if lats else float("nan"),
        "p50_latency_s": _pct(lats, 50.0),
        "p95_latency_s": _pct(lats, 95.0),
        "p99_latency_s": _pct(lats, 99.0),
        "mean_ttft_s": float(np.mean(ttfts)) if ttfts else float("nan"),
        "p95_ttft_s": _pct(ttfts, 95.0),
        "tokens_per_s": tokens / wall,
        "goodput_tokens": good,
        "goodput_tokens_per_s": good / wall,
        "deadline_hit_rate": (hits / len(with_slo)) if with_slo else 1.0,
    }


def run_trace(
    engine: ServingEngine,
    trace: Sequence[TimedRequest],
    *,
    time_scale: float = 1.0,
    poll_interval: float = 0.005,
) -> Dict[str, float]:
    """Drive the engine with the trace, open-loop; return metrics.

    A feeder thread submits each request at ``t0 + at * time_scale``
    regardless of engine progress, while the caller thread serves
    (``engine.run()`` whenever there is work).  ``time_scale`` stretches
    or compresses the trace clock — 0 submits everything immediately
    (the closed-batch limit).  Shed verdicts are counted, not retried:
    open-loop traffic does not wait for permission.
    """
    t0 = time.perf_counter()
    feeder_errors: List[BaseException] = []

    def feeder() -> None:
        try:
            for tr in trace:
                delay = (t0 + tr.at * time_scale) - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                engine.submit(tr.request)
        except BaseException as exc:  # surfaced to the driver below
            feeder_errors.append(exc)

    th = threading.Thread(target=feeder, name="loadgen-feeder", daemon=True)
    th.start()
    try:
        while th.is_alive() or engine.has_work:
            if engine.has_work:
                engine.run()
            else:
                time.sleep(poll_interval)
    finally:
        th.join(timeout=30.0)
    if feeder_errors:
        raise feeder_errors[0]
    wall = time.perf_counter() - t0
    return summarize(engine, wall=wall, offered=len(trace))

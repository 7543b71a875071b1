"""Completion-driven execution engine (ENEAC §3.2 interrupt mechanism).

The paper attaches a dedicated hardware interrupt controller + software
driver + host thread to *each* FPGA accelerator, so (a) every accelerator
runs fully asynchronously and (b) the host thread that offloaded a chunk
sleeps until the interrupt fires instead of burning a CPU core polling.

TPU/JAX adaptation: there are no user-visible interrupts, but JAX's async
dispatch gives the same structure — device work is enqueued and the host
is only blocked when it *chooses* to synchronize.  We reify the paper's
design as:

* :class:`CompletionEvent` — the interrupt analogue: ``fire()`` from the
  completion context (device callback, worker thread), ``wait()`` from the
  offloading host thread which *sleeps* on a condition variable.
* :class:`AsyncEngine` — one host thread per compute unit (exactly the
  paper's per-accelerator host thread), each looping: request chunk from
  the scheduler → dispatch → sleep until completion → report → repeat.
* :class:`PollingEngine` — the "no interrupts" baseline of Table-1 configs
  (4) and (6): a single host thread busy-spins over the units checking for
  completion, stealing cycles from the CC workers.  For the benchmark we
  model the steal by running CC work on the *same* thread that polls.

Both engines drive the *same* :class:`~repro.core.scheduler.MultiDynamicScheduler`,
so the Table-1 reproduction isolates the interrupt mechanism exactly as the
paper does (config (6) vs (7), (4) vs (5)).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .scheduler import Chunk, MultiDynamicScheduler

__all__ = ["CompletionEvent", "AsyncEngine", "PollingEngine", "RunReport"]


class CompletionEvent:
    """Interrupt analogue: host thread sleeps, completion context wakes it."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._fired = False
        self._payload = None

    def fire(self, payload=None) -> None:
        with self._cond:
            self._fired = True
            self._payload = payload
            self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None):
        with self._cond:
            if not self._cond.wait_for(lambda: self._fired, timeout=timeout):
                raise TimeoutError("completion event did not fire")
            return self._payload

    def reset(self) -> None:
        with self._cond:
            self._fired = False
            self._payload = None


@dataclass
class RunReport:
    wall_time: float
    items: int
    chunks: int
    per_worker_items: Dict[str, int]
    per_worker_chunks: Dict[str, int]
    per_worker_busy: Dict[str, float]
    load_balance: float
    # Sorted (start, stop) spans of completed chunks; filled by
    # :class:`repro.core.runtime.HeteroRuntime` (None for bare engine runs).
    coverage: Optional[List[tuple]] = None
    # Elasticity timeline: one dict per unit join/leave processed during the
    # run — {"t", "action", "unit", "requeued": (start, stop) | None}.
    events: Optional[List[dict]] = None
    # Per-shard sub-reports when the run iterated a ShardedSpace; unit keys
    # in the merged per_worker_* maps are prefixed "s{shard}/".
    shard_reports: Optional[List["RunReport"]] = None
    # Mean submit->execution-start latency per unit in seconds, measured by
    # the backend layer (wall-clock interrupt runs only; None otherwise).
    # Low values with overlapping busy times are what "real asynchrony"
    # looks like: the dispatcher never sits between a free unit and work.
    dispatch_latency: Optional[Dict[str, float]] = None
    # The wire + remote-queue component of dispatch_latency for units that
    # executed behind a transport (repro.core.transport.RemoteUnit): mean
    # first-send -> remote-execution-start seconds per unit.  When several
    # chunks shared one work_batch frame (batch_frames > 1), the frame's
    # transit time is attributed per chunk — divided by the number of
    # chunks in the frame — so summing a batch's samples counts the wire
    # hop exactly once instead of once per chunk; the remote queue wait
    # remains genuinely per-chunk.  The local queue component is
    # dispatch_latency[u] - wire_latency[u].  None when no remote unit
    # took part in the run.  Measured by differencing client- and
    # worker-side monotonic clocks, so only meaningful when both share a
    # machine (worker subprocesses).
    wire_latency: Optional[Dict[str, float]] = None
    # Effective frame-coalescing width per transport-backed unit at run
    # end.  For a fixed ``batch_frames=N`` RemoteUnit this is just N; for
    # ``batch_frames="auto"`` it is the converged adaptive value (learned
    # wire transit vs. per-chunk service time, re-evaluated at flush
    # boundaries).  None when no transport unit took part in the run.
    batch_frames: Optional[Dict[str, int]] = None

    @property
    def throughput(self) -> float:
        """Items per millisecond — the paper's metric."""
        return self.items / max(self.wall_time * 1e3, 1e-12)

    @property
    def num_shards(self) -> int:
        return len(self.shard_reports) if self.shard_reports else 1

    @property
    def cross_shard_balance(self) -> float:
        """max shard makespan / mean shard makespan (1.0 = perfect).

        The sharded analogue of ``load_balance``: how evenly the global
        space was split across host shards, each of which load-balances
        internally via its own scheduler.
        """
        if not self.shard_reports:
            return 1.0
        spans = [r.wall_time for r in self.shard_reports]
        mean = sum(spans) / len(spans)
        return max(spans) / max(mean, 1e-12)

    @property
    def makespan(self) -> float:
        """Wall (or virtual) time from first dispatch to last completion."""
        return self.wall_time

    @property
    def utilization(self) -> Dict[str, float]:
        """Busy fraction per unit over the run's makespan."""
        w = max(self.wall_time, 1e-12)
        return {n: min(b / w, 1.0) for n, b in self.per_worker_busy.items()}


WorkFn = Callable[[Chunk], None]


class AsyncEngine:
    """Per-unit host threads + completion events (the paper's §3.2 design).

    ``work_fns[name]`` performs one chunk on unit ``name`` and returns when
    the unit's result is available (for JAX work this is where the function
    calls ``block_until_ready`` on *its own* stream — other units keep
    running, which is the entire point).
    """

    def __init__(self, scheduler: MultiDynamicScheduler, work_fns: Dict[str, WorkFn]) -> None:
        self.scheduler = scheduler
        self.work_fns = work_fns
        missing = set(scheduler.workers) - set(work_fns)
        if missing:
            raise ValueError(f"no work_fn for workers {sorted(missing)}")
        self._errors: List[BaseException] = []
        self._error_lock = threading.Lock()

    def _host_thread(self, name: str) -> None:
        fn = self.work_fns[name]
        while True:
            chunk = self.scheduler.next_chunk(name, now=time.perf_counter())
            if chunk is None:
                return
            t0 = time.perf_counter()
            try:
                fn(chunk)
            except BaseException as exc:  # propagate to .run()
                with self._error_lock:
                    self._errors.append(exc)
                self.scheduler.complete(name, time.perf_counter() - t0)
                return
            self.scheduler.complete(name, time.perf_counter() - t0)

    def run(self) -> RunReport:
        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=self._host_thread, args=(name,), name=f"eneac-{name}")
            for name in self.scheduler.workers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._errors:
            raise self._errors[0]
        wall = time.perf_counter() - t0
        return self._report(wall)

    def _report(self, wall: float) -> RunReport:
        states = self.scheduler.workers
        return RunReport(
            wall_time=wall,
            items=sum(w.items_done for w in states.values()),
            chunks=sum(w.chunks_done for w in states.values()),
            per_worker_items={n: w.items_done for n, w in states.items()},
            per_worker_chunks={n: w.chunks_done for n, w in states.items()},
            per_worker_busy={n: w.total_busy_time for n, w in states.items()},
            load_balance=self.scheduler.load_balance(),
        )


class PollingEngine:
    """Busy-wait baseline (Table-1 configs without interrupts).

    A single host thread drives every unit round-robin: it dispatches ACC
    chunks asynchronously but must *poll* for their completion, and while it
    polls it is the same thread that would execute CC chunks — so CC
    throughput is stolen by the polling loop.  We model the paper's
    measured behaviour by executing all work on the one driver thread:
    ACC work still completes at ACC speed (the accelerator itself is
    asynchronous) but the host serializes dispatch/poll/CC-work.
    """

    def __init__(
        self,
        scheduler: MultiDynamicScheduler,
        work_fns: Dict[str, WorkFn],
        poll_interval: float = 0.0,
    ) -> None:
        self.scheduler = scheduler
        self.work_fns = work_fns
        self.poll_interval = poll_interval

    def run(self) -> RunReport:
        t0 = time.perf_counter()
        names = list(self.scheduler.workers)
        active = True
        while active:
            active = False
            for name in names:
                chunk = self.scheduler.next_chunk(name, now=time.perf_counter())
                if chunk is None:
                    continue
                active = True
                c0 = time.perf_counter()
                self.work_fns[name](chunk)  # serialized on the driver thread
                if self.poll_interval:
                    time.sleep(self.poll_interval)
                self.scheduler.complete(name, time.perf_counter() - c0)
        wall = time.perf_counter() - t0
        states = self.scheduler.workers
        return RunReport(
            wall_time=wall,
            items=sum(w.items_done for w in states.values()),
            chunks=sum(w.chunks_done for w in states.values()),
            per_worker_items={n: w.items_done for n, w in states.items()},
            per_worker_chunks={n: w.chunks_done for n, w in states.items()},
            per_worker_busy={n: w.total_busy_time for n, w in states.items()},
            load_balance=self.scheduler.load_balance(),
        )

"""MultiDynamic heterogeneous chunk scheduler (ENEAC §3.3).

The paper's scheduler exposes a ``parallel_for()`` over an iteration space
``[0, N)`` executed simultaneously by heterogeneous compute units:
*accelerators* (ACC — FPGA blocks in the paper, MXU-dense paths / fast DP
groups here) and *cores* (CC — ARM cores in the paper, VPU-sparse paths /
slow DP groups here).  Its defining properties, reproduced faithfully:

1. The ACC chunk size is **user-specified** (the paper sweeps it; Table 1's
   throughput cliff appears when one ACC chunk exceeds 1/4 of the space).
2. The CC chunk size is **adapted dynamically** to maximize load balance:
   a core should finish its chunk in roughly the time an accelerator
   finishes one of its own, so ``cc_chunk ≈ acc_chunk * (T_cc / T_acc)``
   where ``T_*`` are measured throughputs (items/s), with a guided-style
   decay near the tail so no unit is left holding a large remainder.
3. Chunks are handed to a unit **as soon as it becomes available**
   (completion-driven, see :mod:`repro.core.interrupts`), which is what
   makes the scheme robust to irregular workloads (SPMM in the paper).

The scheduler is pure host-side bookkeeping (plain Python + floats): it
never touches jax device state, so it can be driven from interrupt
callbacks, serving threads, or the training loop alike.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Chunk",
    "WorkerKind",
    "WorkerState",
    "MultiDynamicScheduler",
    "StaticScheduler",
    "OracleStaticScheduler",
    "proportional_split",
    "latency_aware_split",
]

# A measured throughput of exactly 0.0 is still a measurement (the unit is
# stalled), not an invitation to re-apply the optimistic bootstrap prior;
# the floor only protects the arithmetic downstream from division blowups.
THROUGHPUT_FLOOR = 1e-9


def proportional_split(num_items: int, throughputs: Dict[str, float]) -> Dict[str, int]:
    """Split ``[0, num_items)`` proportionally to per-unit throughputs.

    Worker order follows ``throughputs`` insertion order; every non-last
    share is rounded (banker's ``round``) then clamped so rounding can
    never overshoot the space, and the last worker absorbs the exact
    remainder — the split always tiles the space.  Whenever the space has
    at least one item per worker, every positive-throughput worker is
    guaranteed a non-empty share (a slow-but-live unit must not round to
    zero and then idle for the whole run).  Shared by
    :class:`OracleStaticScheduler` (user-supplied speeds) and the learned
    policy in :mod:`repro.core.runtime` (measured speeds from the cost
    model).  Equivalent to :func:`latency_aware_split` at zero overhead.
    """
    return latency_aware_split(num_items, throughputs)


def latency_aware_split(
    num_items: int,
    throughputs: Dict[str, float],
    overheads: Optional[Dict[str, float]] = None,
) -> Dict[str, int]:
    """Split ``[0, num_items)`` to equalize *predicted completion time*.

    ``overheads`` maps worker -> fixed seconds the worker pays before its
    share completes (learned dispatch + wire latency from the cost model);
    missing/None entries mean zero.  The ideal share solves the
    water-filling problem: find the completion level ``tau`` with

        sum_i  T_i * max(tau - L_i, 0)  =  num_items

    so every participating worker finishes at ``n_i / T_i + L_i == tau``,
    and a worker whose overhead alone exceeds ``tau`` drops out of the
    level computation (it would need a negative share).  With all-zero
    overheads this degenerates to a pure throughput-proportional split.

    Rounding and guarantees are shared with :func:`proportional_split`:
    insertion-order banker's rounding with the last *positive-throughput*
    worker absorbing the remainder (a stalled unit never absorbs), and —
    whenever ``num_items >= len(throughputs)`` — at least 1 item for
    every positive-throughput worker (donated from the largest share,
    first-in-order on ties).
    """
    if num_items < 0:
        raise ValueError(f"num_items must be non-negative, got {num_items}")
    if not throughputs:
        raise ValueError("throughputs must not be empty")
    total = sum(throughputs.values())
    if total <= 0:
        raise ValueError(f"throughputs must sum positive, got {total}")
    names = list(throughputs)
    if num_items == 0:
        return {w: 0 for w in names}
    lat = {w: max(float((overheads or {}).get(w) or 0.0), 0.0) for w in names}

    # Water-fill the completion level over positive-throughput workers,
    # dropping the highest-overhead worker while it sits above the level.
    shares = {w: 0.0 for w in names}
    active = [w for w in names if throughputs[w] > 0]
    level = 0.0
    while active:
        t_sum = sum(throughputs[w] for w in active)
        level = (num_items + sum(throughputs[w] * lat[w] for w in active)) / t_sum
        over = [w for w in active if lat[w] >= level]
        if not over:
            break
        worst = max(over, key=lambda w: lat[w])
        active.remove(worst)
    for w in active:
        shares[w] = throughputs[w] * (level - lat[w])

    # Banker's rounding in insertion order; the *last live* worker absorbs
    # the remainder (never a zero-throughput one — handing a stalled unit
    # the rounding slack would strand those items).
    absorber = [w for w in names if throughputs[w] > 0][-1]
    sizes: Dict[str, int] = {}
    start = 0
    for w in names:
        size = min(int(round(shares[w])), num_items - start)
        sizes[w] = size
        start += size
    sizes[absorber] += num_items - start

    # Starvation guarantee: with at least one item per worker available,
    # every positive-throughput worker gets a non-empty share.  Donors are
    # the largest shares (first in insertion order on ties); by pigeonhole
    # a >=2-item donor always exists while some live worker sits at zero.
    if num_items >= len(names):
        for w in names:
            while throughputs[w] > 0 and sizes[w] < 1:
                donor = max(names, key=lambda d: sizes[d])
                sizes[donor] -= 1
                sizes[w] += 1
    return sizes


@dataclass(frozen=True)
class Chunk:
    """A contiguous slice ``[start, stop)`` of the iteration space."""

    start: int
    stop: int
    worker: str

    @property
    def size(self) -> int:
        return self.stop - self.start

    def indices(self) -> range:
        return range(self.start, self.stop)


class WorkerKind:
    ACC = "acc"  # accelerator: fixed, user-set chunk size
    CC = "cc"    # core: dynamically adapted chunk size


@dataclass
class WorkerState:
    name: str
    kind: str
    # items/second, EWMA-updated from completions.  ``None`` until first
    # completion; the scheduler bootstraps with ``initial_throughput``.
    throughput: Optional[float] = None
    items_done: int = 0
    chunks_done: int = 0
    busy: bool = False
    total_busy_time: float = 0.0


class MultiDynamicScheduler:
    """The paper's *MultiDynamic* scheduler.

    Parameters
    ----------
    num_items:
        Size of the iteration space (rows for SPMM/HOTSPOT, microbatches
        for hetero data-parallel training, request slots for serving).
    acc_chunk:
        User-specified accelerator chunk size (the paper's central knob).
    min_cc_chunk / max_cc_chunk:
        Clamp for the adaptive CC chunk.
    ewma_alpha:
        Smoothing for the throughput estimate (paper adapts at runtime;
        EWMA is the standard instantiation).
    initial_acc_speedup:
        Prior for ACC/CC throughput ratio before any completion has been
        observed (the paper seeds from a calibration run).
    """

    def __init__(
        self,
        num_items: int,
        acc_chunk: int,
        *,
        min_cc_chunk: int = 1,
        max_cc_chunk: Optional[int] = None,
        ewma_alpha: float = 0.4,
        initial_acc_speedup: float = 8.0,
        tail_fraction: float = 0.5,
    ) -> None:
        if num_items <= 0:
            raise ValueError(f"num_items must be positive, got {num_items}")
        if acc_chunk <= 0:
            raise ValueError(f"acc_chunk must be positive, got {acc_chunk}")
        self.num_items = num_items
        self.acc_chunk = acc_chunk
        self.min_cc_chunk = min_cc_chunk
        self.max_cc_chunk = max_cc_chunk or max(1, num_items)
        self.ewma_alpha = ewma_alpha
        self.initial_acc_speedup = initial_acc_speedup
        self.tail_fraction = tail_fraction

        self._next = 0
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerState] = {}
        # worker -> FIFO of in-flight chunks.  Plain (capacity-1) drivers
        # only ever have one entry; a pipelined driver (BackendEngine over
        # a batched RemoteUnit) raises the worker's capacity first via
        # set_capacity() and may then keep several in flight.
        self._outstanding: Dict[str, List[Chunk]] = {}
        self._capacity: Dict[str, int] = {}
        self._issue_times: Dict[str, float] = {}
        self._history: List[Tuple[Chunk, float]] = []

    def set_capacity(self, worker: str, capacity: int) -> None:
        """Allow ``worker`` to hold up to ``capacity`` chunks in flight."""
        with self._lock:
            self._capacity[worker] = max(int(capacity), 1)

    # ------------------------------------------------------------------
    # worker registry
    # ------------------------------------------------------------------
    def add_worker(self, name: str, kind: str, throughput: Optional[float] = None) -> None:
        if kind not in (WorkerKind.ACC, WorkerKind.CC):
            raise ValueError(f"unknown worker kind {kind!r}")
        with self._lock:
            if name in self._workers:
                raise ValueError(f"duplicate worker {name!r}")
            self._workers[name] = WorkerState(name=name, kind=kind, throughput=throughput)

    def abort(self, worker: str) -> List[Chunk]:
        """Drop ``worker``'s in-flight chunks without counting them.

        The elastic layer calls this when a unit departs mid-chunk; the
        caller owns requeueing the dropped spans so coverage stays
        exact-once.  Returns *all* aborted chunks oldest-first — with
        ``set_capacity > 1`` a pipelined worker may hold several in
        flight, and returning only the oldest would silently lose
        coverage for any driver that isn't the tracked runtime facade.
        """
        with self._lock:
            state = self._workers.get(worker)
            chunks = self._outstanding.pop(worker, None)
            self._issue_times.pop(worker, None)
            if state is not None:
                state.busy = False
            return list(chunks) if chunks else []

    def remove_worker(self, name: str) -> List[Chunk]:
        """Unregister a unit mid-run (elastic leave); returns all its aborted chunks."""
        chunks = self.abort(name)
        with self._lock:
            self._workers.pop(name, None)
        return chunks

    @property
    def workers(self) -> Dict[str, WorkerState]:
        return dict(self._workers)

    # ------------------------------------------------------------------
    # throughput estimation
    # ------------------------------------------------------------------
    def _estimated_throughput(self, state: WorkerState) -> float:
        if state.throughput is not None:
            # A measurement — even 0.0 from a stalled unit counts; floor it
            # instead of falling through to the optimistic bootstrap prior.
            return max(state.throughput, THROUGHPUT_FLOOR)
        # Bootstrap: unobserved units get a prior relative to observed ones.
        observed = [w.throughput for w in self._workers.values()
                    if w.throughput is not None]
        base = max(min(observed), THROUGHPUT_FLOOR) if observed else 1.0
        if state.kind == WorkerKind.ACC:
            return base * self.initial_acc_speedup
        return base

    def _cc_chunk_size(self, state: WorkerState, remaining: int) -> int:
        """Adapt the CC chunk so a core finishes in about one ACC-chunk time.

        ``cc_chunk = acc_chunk * T_cc / T_acc`` (load-balance condition),
        decayed guided-style over the tail so the final chunks shrink and no
        unit strands the others waiting on a large remainder.
        """
        t_cc = self._estimated_throughput(state)
        accs = [w for w in self._workers.values() if w.kind == WorkerKind.ACC]
        if accs:
            t_acc = max(self._estimated_throughput(a) for a in accs)
        else:
            t_acc = t_cc * self.initial_acc_speedup
        balanced = self.acc_chunk * (t_cc / max(t_acc, 1e-12))
        # Guided tail decay: never take more than tail_fraction of what is
        # left divided by the number of idle units.
        idle = max(1, sum(1 for w in self._workers.values() if not w.busy))
        guided_cap = max(1.0, self.tail_fraction * remaining / idle)
        size = int(max(self.min_cc_chunk, min(balanced, guided_cap, self.max_cc_chunk)))
        return max(1, size)

    # ------------------------------------------------------------------
    # chunk issue / completion (the parallel_for engine of Fig. 2)
    # ------------------------------------------------------------------
    def next_chunk(self, worker: str, now: float = 0.0) -> Optional[Chunk]:
        """Hand the next chunk to ``worker``; ``None`` when space exhausted.

        A worker may hold several chunks at once when its driver pipelines
        and raised the worker's capacity via :meth:`set_capacity`; at the
        default capacity of 1 a busy worker cannot double-issue.  ``busy``
        means "has at least one chunk in flight", which is what the CC
        chunk-size adaptation's idle count keys on.
        """
        with self._lock:
            state = self._workers[worker]
            pending = self._outstanding.get(worker, ())
            if len(pending) >= self._capacity.get(worker, 1):
                raise RuntimeError(f"worker {worker!r} requested a chunk while busy")
            remaining = self.num_items - self._next
            if remaining <= 0:
                return None
            if state.kind == WorkerKind.ACC:
                size = min(self.acc_chunk, remaining)
            else:
                size = min(self._cc_chunk_size(state, remaining), remaining)
            chunk = Chunk(self._next, self._next + size, worker)
            self._next += size
            state.busy = True
            self._outstanding.setdefault(worker, []).append(chunk)
            self._issue_times[worker] = now
            return chunk

    def complete(self, worker: str, elapsed: float,
                 chunk: Optional[Chunk] = None) -> None:
        """Record a completion (called by the interrupt/event layer).

        ``chunk`` selects which in-flight chunk finished when the worker
        pipelines several (matched on ``(start, stop)``); ``None`` means
        FIFO — the only case for capacity-1 drivers, where it is exact.
        """
        with self._lock:
            state = self._workers[worker]
            pending = self._outstanding.get(worker)
            if not pending:
                raise RuntimeError(f"completion from {worker!r} with no outstanding chunk")
            if chunk is None:
                done = pending.pop(0)
            else:
                for i, c in enumerate(pending):
                    if (c.start, c.stop) == (chunk.start, chunk.stop):
                        done = pending.pop(i)
                        break
                else:
                    raise RuntimeError(
                        f"completion from {worker!r} for span "
                        f"[{chunk.start}, {chunk.stop}) that is not outstanding"
                    )
            if not pending:
                del self._outstanding[worker]
                state.busy = False
            state.items_done += done.size
            state.chunks_done += 1
            state.total_busy_time += max(elapsed, 1e-12)
            inst = done.size / max(elapsed, 1e-12)
            if state.throughput is None:
                state.throughput = inst
            else:
                a = self.ewma_alpha
                state.throughput = a * inst + (1 - a) * state.throughput
            self._history.append((done, elapsed))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        with self._lock:
            return self._next >= self.num_items and not self._outstanding

    @property
    def issued(self) -> int:
        with self._lock:
            return self._next

    def coverage(self) -> List[Tuple[int, int]]:
        """Sorted (start, stop) of all completed chunks — for invariants."""
        with self._lock:
            spans = sorted((c.start, c.stop) for c, _ in self._history)
        return spans

    def load_balance(self) -> float:
        """max busy time / mean busy time across units (1.0 = perfect)."""
        with self._lock:
            times = [w.total_busy_time for w in self._workers.values() if w.chunks_done]
        if not times:
            return 1.0
        mean = sum(times) / len(times)
        return max(times) / max(mean, 1e-12)


class StaticScheduler:
    """Baseline: pre-split the space evenly across units (no adaptation).

    This is the strawman the paper's dynamic scheme beats on irregular
    workloads; kept for the Table-1-style ablation.
    """

    def __init__(self, num_items: int, workers: List[str]) -> None:
        self.num_items = num_items
        self._assignments: Dict[str, Iterator[Chunk]] = {}
        n = len(workers)
        per = num_items // n
        rem = num_items % n
        start = 0
        for i, w in enumerate(workers):
            size = per + (1 if i < rem else 0)
            chunk = Chunk(start, start + size, w)
            self._assignments[w] = iter([chunk] if size else [])
            start += size

    def next_chunk(self, worker: str, now: float = 0.0) -> Optional[Chunk]:
        return next(self._assignments[worker], None)

    def complete(self, worker: str, elapsed: float,
                 chunk: Optional[Chunk] = None) -> None:  # pragma: no cover
        pass


class OracleStaticScheduler:
    """Static split proportional to *known* throughputs (upper bound for
    regular workloads; still loses to MultiDynamic on irregular ones)."""

    def __init__(
        self,
        num_items: int,
        throughputs: Dict[str, float],
        overheads: Optional[Dict[str, float]] = None,
    ) -> None:
        self.num_items = num_items
        self._assignments: Dict[str, Optional[Chunk]] = {}
        start = 0
        split = latency_aware_split(num_items, throughputs, overheads)
        for w, size in split.items():
            self._assignments[w] = Chunk(start, start + size, w) if size > 0 else None
            start += size

    def next_chunk(self, worker: str, now: float = 0.0) -> Optional[Chunk]:
        chunk = self._assignments.get(worker)
        self._assignments[worker] = None
        return chunk

    def complete(self, worker: str, elapsed: float,
                 chunk: Optional[Chunk] = None) -> None:  # pragma: no cover
        pass

"""HeteroRuntime — the unified async runtime of the ENEAC reproduction.

The paper's Fig. 2 pipeline is one loop: register heterogeneous compute
units, hand each idle unit a chunk of the iteration space the moment it
completes the previous one, and adapt chunk sizes from measured
throughput.  Before this module the three pillars of that loop —
:class:`~repro.core.scheduler.MultiDynamicScheduler` (chunking policy),
:class:`~repro.core.interrupts.AsyncEngine` / ``PollingEngine``
(completion mechanism), and the workload adapters
(:class:`~repro.core.parallel_for.HybridExecutor`, the serving refill
loop, the Table-1 harness) — were wired ad hoc at every call site.
:class:`HeteroRuntime` is the one front door:

    rt = HeteroRuntime()
    rt.register_unit("acc0", WorkerKind.ACC, speed=8e4, work_fn=acc_work)
    rt.register_unit("cc0", WorkerKind.CC, speed=1e4, work_fn=cc_work)
    report = rt.parallel_for(num_items=4096, policy="multidynamic",
                             engine="interrupt", acc_chunk=256)

Orthogonal knobs, matching the paper's ablation axes:

* ``policy`` — how the space is chunked: ``"multidynamic"`` (the paper's
  adaptive scheme), ``"static"`` (even pre-split baseline), ``"oracle"``
  (throughput-proportional pre-split from *registered* speeds),
  ``"learned"`` (proportional pre-split from *measured* speeds in the
  runtime's attached :class:`~repro.core.costmodel.CostModel`, falling
  back to adaptive until every unit has been observed), or an explicit
  ``{unit: (start, stop)}`` mapping for externally-decided splits.
* ``engine`` — how completions are observed: ``"interrupt"`` (the
  event-driven :class:`~repro.core.backends.BackendEngine`: chunks
  execute on real backend units — dedicated threads, process pools, CUDA
  streams — and completions arrive on a condition variable,
  §3.2 made real), ``"polling"`` (single busy-wait driver — the
  no-interrupt baseline), ``"inline"`` (deterministic single-threaded
  serial execution, for tests).
* ``clock`` — :class:`WallClock` for real execution, or
  :class:`SimulatedClock` for deterministic virtual-time runs: unit
  latencies come from registered ``speed`` priors and an optional
  per-item cost vector, no thread ever sleeps, and scheduler dynamics
  (adaptation, completion order, makespan) are exactly reproducible.
* ``space`` — *what* is iterated: a plain ``num_items`` (sugar for
  :class:`~repro.core.space.FlatSpace`), a
  :class:`~repro.core.space.TiledSpace` handing the scheduler 2D kernel
  tiles, or a :class:`~repro.core.space.ShardedSpace` that runs one
  scheduler + engine per host shard and merges the per-shard reports
  into a global one (coverage union, cross-shard balance).
* ``elastic`` — an :class:`~repro.core.elastic.ElasticSchedule` of unit
  join/leave events applied mid-run: under :class:`SimulatedClock` a
  departing unit's in-flight chunk is requeued and re-issued to a
  survivor; under :class:`WallClock` (interrupt engine) the unit is
  retired — its in-flight chunk completes, pre-split leftovers are
  requeued.  A joining unit starts stealing immediately and every event
  lands in ``RunReport.events``.
* ``backend`` — where wall-clock chunks execute: per-unit via
  ``register_unit(backend=...)`` or per-call override; see
  :mod:`repro.core.backends`.

Every run returns a :class:`~repro.core.interrupts.RunReport` carrying
makespan, per-unit utilization, load balance, and the exact coverage
spans — the invariants the test suite checks.  See
``docs/architecture.md`` for the full design and ``docs/runtime_api.md``
for the reference.
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .backends import BackendEngine, BackendUnit, make_backend
from .costmodel import CostModel
from .elastic import ElasticEvent, ElasticSchedule
from .interrupts import PollingEngine, RunReport
from .scheduler import (
    Chunk,
    MultiDynamicScheduler,
    OracleStaticScheduler,
    StaticScheduler,
    WorkerKind,
    WorkerState,
)
from .space import FlatSpace, IterationSpace, ShardedSpace, TiledSpace, as_space
from .straggler import StragglerDetector

__all__ = [
    "HeteroRuntime",
    "SimulatedClock",
    "UnitSpec",
    "WallClock",
    "WorkQueue",
]

WorkFn = Callable[[Chunk], None]
# "learned" must stay last: property batteries index POLICIES[pick % 3]
# to draw from the three cost-free policies.
POLICIES = ("multidynamic", "static", "oracle", "learned")
ENGINES = ("interrupt", "polling", "inline")


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------
class WallClock:
    """Real time — units run their actual work functions."""

    def now(self) -> float:
        return time.perf_counter()


class SimulatedClock:
    """Virtual time — unit latencies are modelled, nothing sleeps.

    ``parallel_for`` advances this clock event-by-event, so scheduler
    behaviour (chunk adaptation, completion ordering, makespan) is exactly
    deterministic and a full Table-1-style sweep runs in microseconds.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance the clock backwards ({dt})")
        self._t += dt


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
@dataclass
class UnitSpec:
    """A registered compute unit.

    ``speed`` is the calibration prior in items/second: the oracle policy
    splits proportionally to it, the multidynamic scheduler seeds its
    throughput estimate with it, and :class:`SimulatedClock` runs use it as
    the unit's virtual execution rate.  ``work_fn`` is the unit's default
    chunk executor (overridable per ``parallel_for`` call).  ``backend``
    decides *where* wall-clock chunks execute — ``"inline"``, ``"thread"``
    (default), ``"process"``, ``"cuda"``, or a
    :class:`~repro.core.backends.BackendUnit` instance — and is ignored
    under :class:`SimulatedClock`, where execution is virtual.
    """

    name: str
    kind: str = WorkerKind.CC
    speed: Optional[float] = None
    work_fn: Optional[WorkFn] = None
    backend: Optional[Union[str, BackendUnit]] = None


# ---------------------------------------------------------------------------
# uniform scheduler facade
# ---------------------------------------------------------------------------
class _FixedScheduler:
    """Pre-decided ``{unit: (start, stop)}`` split (externally planned)."""

    def __init__(self, assignments: Mapping[str, Tuple[int, int]]) -> None:
        self._assignments: Dict[str, Optional[Chunk]] = {
            w: Chunk(a, b, w) if b > a else None for w, (a, b) in assignments.items()
        }

    def next_chunk(self, worker: str, now: float = 0.0) -> Optional[Chunk]:
        chunk = self._assignments.get(worker)
        self._assignments[worker] = None
        return chunk

    def complete(self, worker: str, elapsed: float, chunk=None) -> None:
        pass


class _TrackedScheduler:
    """Engine-facing facade over any chunking policy.

    The engines (:class:`AsyncEngine`, :class:`PollingEngine`) and the
    report builder need per-unit state, coverage history, and load-balance
    metrics; only :class:`MultiDynamicScheduler` keeps those natively.
    This facade adds uniform bookkeeping on top of every policy, so one
    engine implementation drives them all.  It also owns the two concerns
    the inner policies stay ignorant of:

    * ``offset`` — shard placement: the inner policy chunks a local
      ``[0, shard_size)`` while issued chunks carry *global* indices.
    * the requeue buffer — elastic leave support: a departed unit's
      in-flight (and, for pre-split policies, never-issued) spans go
      here and are served to any unit, before fresh inner chunks, so
      coverage stays exact-once.
    """

    def __init__(self, inner, unit_kinds: Mapping[str, str], *, offset: int = 0) -> None:
        self.inner = inner
        self.offset = int(offset)
        self._lock = threading.Lock()
        self._states: Dict[str, WorkerState] = {
            n: WorkerState(name=n, kind=k) for n, k in unit_kinds.items()
        }
        # which units the inner policy knows; joined units under a
        # pre-split policy serve only from the requeue buffer
        self._inner_known = set(unit_kinds)
        self._removed: set = set()
        # outstanding: worker -> FIFO of (global chunk, came_from_requeue).
        # Capacity-1 drivers keep at most one entry; a pipelined driver
        # (BackendEngine over a batched RemoteUnit) may keep up to the
        # unit's declared capacity — see set_capacity().
        self._outstanding: Dict[str, List[Tuple[Chunk, bool]]] = {}
        self._capacity: Dict[str, int] = {}
        self._requeued: List[Chunk] = []
        self._history: List[Tuple[Chunk, float]] = []

    @property
    def workers(self) -> Dict[str, WorkerState]:
        return dict(self._states)

    @property
    def removed(self) -> set:
        return set(self._removed)

    def items_done(self) -> int:
        with self._lock:
            return sum(s.items_done for s in self._states.values())

    def _shift(self, chunk: Chunk) -> Chunk:
        if self.offset == 0:
            return chunk
        return Chunk(chunk.start + self.offset, chunk.stop + self.offset, chunk.worker)

    def set_capacity(self, worker: str, capacity: int) -> None:
        """Allow ``worker`` to hold up to ``capacity`` chunks in flight.

        The engine sets this from the backend unit's declared
        ``capacity`` (``batch_frames`` for a batched RemoteUnit); the
        default of 1 preserves the strict submit-only-while-idle
        invariant for every other driver.
        """
        with self._lock:
            self._capacity[worker] = max(int(capacity), 1)
        inner_set = getattr(self.inner, "set_capacity", None)
        if inner_set is not None:
            inner_set(worker, capacity)

    def next_chunk(self, worker: str, now: float = 0.0) -> Optional[Chunk]:
        with self._lock:
            state = self._states[worker]
            if worker in self._removed:
                return None
            pending = self._outstanding.get(worker, ())
            if len(pending) >= self._capacity.get(worker, 1):
                raise RuntimeError(f"unit {worker!r} requested a chunk while busy")
            if self._requeued:
                span = self._requeued.pop(0)
                chunk = Chunk(span.start, span.stop, worker)
                from_requeue = True
            elif worker in self._inner_known:
                chunk = self.inner.next_chunk(worker, now=now)
                if chunk is None or chunk.size <= 0:
                    return None
                chunk = self._shift(chunk)
                from_requeue = False
            else:
                return None
            state.busy = True
            self._outstanding.setdefault(worker, []).append((chunk, from_requeue))
            return chunk

    def complete(self, worker: str, elapsed: float,
                 chunk: Optional[Chunk] = None) -> None:
        """Record a completion.  ``chunk`` (matched on global
        ``(start, stop)``) selects among several in-flight chunks when the
        worker pipelines; ``None`` means FIFO, exact for capacity-1."""
        with self._lock:
            state = self._states[worker]
            pending = self._outstanding.get(worker)
            if not pending:
                raise RuntimeError(f"completion from idle unit {worker!r}")
            if chunk is None:
                done, from_requeue = pending.pop(0)
            else:
                for i, (c, fr) in enumerate(pending):
                    if (c.start, c.stop) == (chunk.start, chunk.stop):
                        done, from_requeue = pending.pop(i)
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
            self._history.append((done, elapsed))
        if not from_requeue:
            inner_chunk = None
            if chunk is not None and self.offset:
                inner_chunk = Chunk(done.start - self.offset,
                                    done.stop - self.offset, done.worker)
            elif chunk is not None:
                inner_chunk = done
            self.inner.complete(worker, elapsed, chunk=inner_chunk)

    # -- elastic membership -------------------------------------------------
    def add_unit(
        self, name: str, kind: str, throughput: Optional[float] = None
    ) -> None:
        """Admit a unit mid-run (elastic join)."""
        with self._lock:
            if name in self._states:
                raise ValueError(
                    f"unit {name!r} already participated in this run; "
                    "joining units need fresh names"
                )
            self._states[name] = WorkerState(name=name, kind=kind)
            if hasattr(self.inner, "add_worker"):
                self.inner.add_worker(name, kind, throughput=throughput)
                self._inner_known.add(name)

    def remove_unit(self, name: str) -> Optional[Chunk]:
        """Retire a unit mid-run (elastic leave).

        All of the unit's in-flight chunks — and, for pre-split policies,
        any assignment it never collected — move to the requeue buffer.
        Returns the oldest aborted in-flight chunk (global indices) or
        None.
        """
        with self._lock:
            if name not in self._states or name in self._removed:
                raise ValueError(f"cannot remove unknown/departed unit {name!r}")
            self._removed.add(name)
            state = self._states[name]
            state.busy = False
            entries = self._outstanding.pop(name, None) or []
            inflight = None
            for chunk, _ in entries:
                if inflight is None:
                    inflight = chunk
                self._requeued.append(chunk)
            if name in self._inner_known:
                self._inner_known.discard(name)
                if hasattr(self.inner, "remove_worker"):
                    # aborts the inner policy's outstanding chunk too
                    self.inner.remove_worker(name)
                else:
                    # pre-split policies (static/oracle/fixed): drain the
                    # departed unit's never-issued assignments
                    while True:
                        leftover = self.inner.next_chunk(name, now=0.0)
                        if leftover is None or leftover.size <= 0:
                            break
                        self._requeued.append(self._shift(leftover))
            return inflight

    def has_requeued(self) -> bool:
        with self._lock:
            return bool(self._requeued)

    def coverage(self) -> List[Tuple[int, int]]:
        with self._lock:
            return sorted((c.start, c.stop) for c, _ in self._history)

    def load_balance(self) -> float:
        with self._lock:
            times = [s.total_busy_time for s in self._states.values() if s.chunks_done]
        if not times:
            return 1.0
        mean = sum(times) / len(times)
        return max(times) / max(mean, 1e-12)


# ---------------------------------------------------------------------------
# serving-style incremental feed
# ---------------------------------------------------------------------------
class WorkQueue:
    """Pull-based view of a run for callers that own their own step loop.

    ``parallel_for`` drives units to completion; a continuous-batching
    server instead interleaves scheduling with its own lockstep decode
    steps.  ``acquire(unit)`` hands the unit its next chunk the moment it
    is free (the completion-driven refill rule), ``complete(unit)``
    reports it back, and ``report()`` closes the run with the same
    :class:`RunReport` a ``parallel_for`` would produce.
    """

    def __init__(self, sched: _TrackedScheduler, clock) -> None:
        self._sched = sched
        self._clock = clock
        self._issue: Dict[str, float] = {}
        self._t0 = clock.now()

    def acquire(self, unit: str) -> Optional[Chunk]:
        chunk = self._sched.next_chunk(unit, now=self._clock.now())
        if chunk is not None:
            self._issue[unit] = self._clock.now()
        return chunk

    def complete(self, unit: str) -> None:
        t0 = self._issue.pop(unit, self._clock.now())
        self._sched.complete(unit, self._clock.now() - t0)

    @property
    def idle_units(self) -> List[str]:
        return [n for n, s in self._sched.workers.items() if not s.busy]

    def report(self) -> RunReport:
        return _build_report(self._sched, self._clock.now() - self._t0)


def _build_report(
    sched: _TrackedScheduler, wall: float,
    dispatch: Optional[Dict[str, float]] = None,
    wire: Optional[Dict[str, float]] = None,
    batch_frames: Optional[Dict[str, int]] = None,
) -> RunReport:
    states = sched.workers
    return RunReport(
        wall_time=wall,
        items=sum(s.items_done for s in states.values()),
        chunks=sum(s.chunks_done for s in states.values()),
        per_worker_items={n: s.items_done for n, s in states.items()},
        per_worker_chunks={n: s.chunks_done for n, s in states.items()},
        per_worker_busy={n: s.total_busy_time for n, s in states.items()},
        load_balance=sched.load_balance(),
        coverage=sched.coverage(),
        dispatch_latency=dispatch,
        wire_latency=wire,
        batch_frames=batch_frames,
    )


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------
class HeteroRuntime:
    """One registry of heterogeneous units, many ways to run them."""

    def __init__(self, *, clock=None, cost_model: Optional[CostModel] = None) -> None:
        self.clock = clock if clock is not None else WallClock()
        self.cost_model = cost_model
        self._units: Dict[str, UnitSpec] = {}

    # -- unit registry ------------------------------------------------------
    def register_unit(
        self,
        name: str,
        kind: str = WorkerKind.CC,
        *,
        speed: Optional[float] = None,
        work_fn: Optional[WorkFn] = None,
        backend: Optional[Union[str, BackendUnit]] = None,
    ) -> UnitSpec:
        if kind not in (WorkerKind.ACC, WorkerKind.CC):
            raise ValueError(f"unknown unit kind {kind!r}")
        if name in self._units:
            raise ValueError(f"duplicate unit {name!r}")
        if backend is not None:
            # validate eagerly: spec strings must name a known backend and
            # instance names must match the unit (completion routing key)
            make_backend(backend, name)
        spec = UnitSpec(name=name, kind=kind, speed=speed, work_fn=work_fn,
                        backend=backend)
        self._units[name] = spec
        return spec

    def deregister_unit(self, name: str) -> UnitSpec:
        """Remove a unit from the registry (fleet scale-down path).

        Only affects *future* runs — a run in flight resolved its specs
        at call time and retires units through the elastic path instead.
        Raises ``KeyError`` for unknown names so a double-drain is loud.
        """
        if name not in self._units:
            raise KeyError(f"unknown unit {name!r}")
        return self._units.pop(name)

    def set_speed(self, name: str, speed: float) -> None:
        self._units[name].speed = speed

    @property
    def units(self) -> Dict[str, UnitSpec]:
        return dict(self._units)

    def _resolve_units(self, units: Optional[Sequence[str]]) -> List[UnitSpec]:
        names = list(units) if units is not None else list(self._units)
        if not names:
            raise ValueError("no units registered")
        missing = [n for n in names if n not in self._units]
        if missing:
            raise ValueError(f"unknown units {missing}")
        return [self._units[n] for n in names]

    # -- scheduling policies ------------------------------------------------
    def _make_scheduler(
        self,
        num_items: int,
        specs: List[UnitSpec],
        policy: Union[str, Mapping[str, Tuple[int, int]]],
        acc_chunk: int,
        scheduler_kwargs: Optional[dict],
        *,
        offset: int = 0,
        kernel: str = "default",
    ) -> _TrackedScheduler:
        kinds = {s.name: s.kind for s in specs}
        if isinstance(policy, Mapping):
            inner = _FixedScheduler(policy)
        elif policy == "multidynamic":
            inner = MultiDynamicScheduler(num_items, acc_chunk, **(scheduler_kwargs or {}))
            for s in specs:
                inner.add_worker(s.name, s.kind, throughput=s.speed)
        elif policy == "static":
            inner = StaticScheduler(num_items, [s.name for s in specs])
        elif policy == "oracle":
            inner = OracleStaticScheduler(
                num_items,
                {s.name: (1.0 if s.speed is None else s.speed) for s in specs},
            )
        elif policy == "learned":
            # Like oracle, but the speeds are *measured*: the attached cost
            # model's per-(unit, kernel) EWMA throughputs.  Registered
            # ``speed`` priors are deliberately not consulted — they are the
            # ground truth the model is supposed to discover.  Until every
            # unit has an observation, fall back to the adaptive scheduler
            # seeded with whatever partial knowledge the model holds.
            names = [s.name for s in specs]
            learned = (self.cost_model.speeds(names, kernel)
                       if self.cost_model is not None else {})
            if len(learned) == len(names):
                # Latency-aware pre-split: size shares to equalize
                # *predicted completion time* (execution + learned
                # dispatch/wire overhead), so a high-latency remote unit
                # gets fewer items than its raw throughput share.  Runs
                # with no latency samples (SimulatedClock) degrade to the
                # pure throughput-proportional split.
                inner = OracleStaticScheduler(
                    num_items, {n: learned[n] for n in names},
                    overheads=self.cost_model.overheads(names, kernel),
                )
            else:
                inner = MultiDynamicScheduler(
                    num_items, acc_chunk, **(scheduler_kwargs or {})
                )
                for s in specs:
                    inner.add_worker(s.name, s.kind,
                                     throughput=learned.get(s.name))
        else:
            raise ValueError(f"unknown policy {policy!r} (want {POLICIES} or a mapping)")
        return _TrackedScheduler(inner, kinds, offset=offset)

    def plan(
        self,
        num_items: int,
        *,
        units: Optional[Sequence[str]] = None,
        policy: str = "oracle",
        acc_chunk: int = 64,
        kernel: str = "default",
    ) -> Dict[str, Tuple[int, int]]:
        """Dry-run split: the first chunk each unit would receive.

        For the static policies this *is* the full partition; clients like
        :class:`~repro.core.parallel_for.HybridExecutor` use it to place
        work without running the engine.  ``kernel`` selects which cost
        model entries a ``policy="learned"`` plan consults.
        """
        specs = self._resolve_units(units)
        sched = self._make_scheduler(num_items, specs, policy, acc_chunk, None,
                                     kernel=kernel)
        out: Dict[str, Tuple[int, int]] = {}
        for s in specs:
            chunk = sched.next_chunk(s.name, now=0.0)
            if chunk is not None:
                out[s.name] = (chunk.start, chunk.stop)
        return out

    def work_queue(
        self,
        num_items: int = 0,
        *,
        space: Optional[Union[int, IterationSpace]] = None,
        units: Optional[Sequence[str]] = None,
        policy: Union[str, Mapping[str, Tuple[int, int]]] = "multidynamic",
        acc_chunk: int = 1,
        scheduler_kwargs: Optional[dict] = None,
        kernel: str = "default",
    ) -> WorkQueue:
        """Open an incremental completion-driven feed over an iteration space.

        Accepts ``num_items`` (a flat range) or any non-sharded ``space``;
        sharded spaces need per-shard engines and belong to
        :meth:`parallel_for`.
        """
        sp = as_space(space, num_items)
        if isinstance(sp, ShardedSpace):
            raise ValueError("work_queue cannot iterate a ShardedSpace")
        specs = self._resolve_units(units)
        sched = self._make_scheduler(
            sp.num_items, specs, policy, acc_chunk, scheduler_kwargs,
            kernel=kernel,
        )
        return WorkQueue(sched, self.clock)

    # -- the paper's parallel_for ------------------------------------------
    def parallel_for(
        self,
        work_fn: Optional[WorkFn] = None,
        num_items: int = 0,
        *,
        space: Optional[Union[int, IterationSpace]] = None,
        units: Optional[Sequence[str]] = None,
        policy: Union[str, Mapping[str, Tuple[int, int]]] = "multidynamic",
        engine: str = "interrupt",
        acc_chunk: int = 64,
        item_cost: Optional[Sequence[float]] = None,
        poll_interval: float = 0.0,
        scheduler_kwargs: Optional[dict] = None,
        elastic: Optional[Union[ElasticSchedule, Sequence[ElasticEvent]]] = None,
        backend: Optional[Union[str, BackendUnit]] = None,
        kernel: str = "default",
        straggler: Optional[StragglerDetector] = None,
    ) -> RunReport:
        """Execute an iteration space across the registered units.

        The space is ``[0, num_items)`` by default, or any
        :class:`~repro.core.space.IterationSpace` via ``space=``: a
        :class:`~repro.core.space.TiledSpace` feeds the scheduler 2D
        kernel tile indices, and a :class:`~repro.core.space.ShardedSpace`
        runs one scheduler/engine per host shard over its slice and
        merges per-shard reports into a global one (``shard_reports``,
        coverage union, ``cross_shard_balance``).  Chunks always carry
        *global* indices.

        ``work_fn`` applies to every unit; omit it to use each unit's
        registered ``work_fn``.  Under a :class:`SimulatedClock`, work
        functions are optional — chunk latency is ``sum(item_cost[chunk])
        / unit.speed`` in virtual time and any provided work functions are
        still invoked (untimed, at chunk completion, exactly once per
        completed chunk) so callers can record side effects.

        ``elastic`` is a timeline of unit join/leave events with
        *run-relative* times, recorded in ``RunReport.events``; events
        timed after the space is fully covered are dropped.  Under
        :class:`SimulatedClock` a leave models an instant FPGA reprogram
        (the in-flight chunk is requeued to survivors); under
        :class:`WallClock` — supported on the ``"interrupt"`` engine only
        — a leave *retires* the unit (its in-flight chunk completes and
        counts, because real work cannot be recalled, and any uncollected
        pre-split assignment is requeued).  Joins steal immediately in
        both modes; wall-clock joins run the call's ``work_fn`` on a
        fresh backend.  With a sharded space the timeline applies to
        every shard's unit replica set independently.

        ``backend`` overrides every unit's registered wall-clock backend
        for this call: ``"inline"``, ``"thread"``/``"threads"``,
        ``"process"``, ``"cuda"``, ``"remote:<host:port>"`` (a
        :class:`~repro_torch.core.transport.RemoteUnit` proxy to a worker
        hosting the execution across a transport; non-sharded runs only
        at call level — register per-unit addresses and pin them for
        sharded runs), or a :class:`~repro.core.backends.BackendUnit`
        instance (single-unit runs only).  See
        :mod:`repro_torch.core.backends` and :mod:`repro_torch.core.transport`.

        ``kernel`` names the workload for the attached cost model (the
        per-(unit, kernel) learning key): with a ``cost_model=`` on the
        runtime every run's per-unit throughputs and latencies are folded
        in under this key, and ``policy="learned"`` splits the space from
        the model's measured speeds for this kernel — an oracle-style
        proportional pre-split once every unit has been observed, the
        adaptive multidynamic scheduler (seeded with whatever partial
        knowledge exists) before that.  Registered ``speed`` priors are
        never consulted by the learned policy.

        ``straggler`` attaches a
        :class:`~repro.core.straggler.StragglerDetector` to the run
        (wall-clock ``"interrupt"`` engine, non-sharded only — one
        detector cannot be shared by concurrent shard engines): every
        chunk completion feeds per-item service time, and a unit whose
        EWMA breaches the fleet median for the detector's configured
        consecutive patience is *quarantined* — retired through the
        elastic leave path, so its in-flight chunk completes, pre-split
        leftovers requeue exact-once to survivors, and the report gains
        an ``action="straggler"`` event.  The last active unit is never
        quarantined.
        """
        if work_fn is not None and not callable(work_fn):
            raise TypeError(
                f"first argument is the work function, got {work_fn!r}; "
                "pass the space size as num_items=N"
            )
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (want one of {ENGINES})")
        if space is None and num_items <= 0:
            raise ValueError(f"num_items must be positive, got {num_items}")
        sp = as_space(space, num_items)
        specs = self._resolve_units(units)

        simulated = isinstance(self.clock, SimulatedClock)
        elastic_events = self._normalize_elastic(elastic, specs)
        if elastic_events and not simulated:
            if engine != "interrupt":
                raise ValueError(
                    "elastic join/leave under a WallClock needs the "
                    "event-driven 'interrupt' engine (serial polling/inline "
                    "drivers cannot observe membership changes mid-chunk); "
                    "use a SimulatedClock for deterministic serial replay"
                )
            if any(ev.action == "join" for ev in elastic_events) and work_fn is None:
                raise ValueError(
                    "wall-clock joins need an explicit work_fn argument "
                    "(the joining unit has no registered one)"
                )
        fns: Dict[str, Optional[WorkFn]] = {
            s.name: (work_fn if work_fn is not None else s.work_fn) for s in specs
        }
        if not simulated:
            missing = [n for n, f in fns.items() if f is None]
            if missing:
                raise ValueError(
                    f"units {missing} have no work_fn (required on a wall clock)"
                )
            if item_cost is not None:
                raise ValueError("item_cost is only meaningful under SimulatedClock")
        if isinstance(backend, BackendUnit) and len(specs) > 1:
            raise ValueError(
                "a single BackendUnit instance cannot back multiple units; "
                "pass a backend spec string or register per-unit instances"
            )
        if item_cost is not None and len(item_cost) != sp.num_items:
            raise ValueError(
                f"item_cost has {len(item_cost)} entries for {sp.num_items} items"
            )
        if straggler is not None:
            if simulated:
                raise ValueError(
                    "straggler detection runs in the wall-clock BackendEngine; "
                    "a SimulatedClock run has no real service times to watch "
                    "— model slowdowns via item_cost/speed instead"
                )
            if engine != "interrupt":
                raise ValueError(
                    "straggler detection needs the event-driven 'interrupt' "
                    "engine (serial drivers cannot quarantine mid-run)"
                )
            if isinstance(sp, ShardedSpace):
                raise ValueError(
                    "one StragglerDetector cannot be shared by concurrent "
                    "shard engines; run per-shard parallel_for calls with "
                    "their own detectors instead"
                )

        if isinstance(sp, ShardedSpace):
            if isinstance(policy, Mapping):
                raise ValueError(
                    "a fixed {unit: (start, stop)} policy is ambiguous over a "
                    "ShardedSpace; use multidynamic/static/oracle"
                )
            if isinstance(backend, BackendUnit):
                raise ValueError(
                    "a single BackendUnit instance cannot back a ShardedSpace "
                    "run (each shard engine needs its own workers); pass a "
                    "backend spec string instead"
                )
            if isinstance(backend, str) and backend.startswith("remote:"):
                raise ValueError(
                    "a call-level remote backend would make every shard "
                    "replicate its units onto one worker host; register "
                    "per-unit remote backends and pin them via "
                    "ShardedSpace(placement={unit: shard}) instead"
                )
            rep = self._run_sharded(
                sp, specs, fns, work_fn, policy, engine, acc_chunk,
                item_cost, poll_interval, scheduler_kwargs, elastic_events,
                backend, kernel=kernel,
            )
        else:
            sched = self._make_scheduler(
                sp.num_items, specs, policy, acc_chunk, scheduler_kwargs,
                kernel=kernel,
            )
            if simulated:
                rep = self._run_simulated(
                    sched, specs, fns, engine, sp.num_items, item_cost,
                    poll_interval, clock=self.clock, elastic=elastic_events,
                    expected=sp.num_items, default_fn=work_fn,
                )
            else:
                rep = self._run_wall(
                    sched, specs, fns, engine, poll_interval,
                    elastic=elastic_events, expected=sp.num_items,
                    default_fn=work_fn, backend=backend, straggler=straggler,
                )
        if self.cost_model is not None:
            # every run teaches the model — including multidynamic warmups,
            # which is what lets a later policy="learned" run pre-split
            self.cost_model.observe_report(rep, kernel)
        return rep

    @staticmethod
    def _normalize_elastic(
        elastic: Optional[Union[ElasticSchedule, Sequence[ElasticEvent]]],
        specs: List[UnitSpec],
    ) -> List[ElasticEvent]:
        if elastic is None:
            return []
        events = list(elastic.events if isinstance(elastic, ElasticSchedule) else elastic)
        events.sort(key=lambda e: e.t)
        known = {s.name for s in specs}
        departed: set = set()
        for ev in events:
            if ev.action == "join":
                if ev.unit in known or ev.unit in departed:
                    raise ValueError(
                        f"join event reuses unit name {ev.unit!r}; "
                        "joining units need fresh names"
                    )
                known.add(ev.unit)
            else:
                if ev.unit not in known:
                    raise ValueError(
                        f"leave event for unknown or already-departed unit "
                        f"{ev.unit!r}"
                    )
                known.discard(ev.unit)
                departed.add(ev.unit)
        return events

    # -- wall-clock execution ----------------------------------------------
    def _run_wall(
        self,
        sched: _TrackedScheduler,
        specs: List[UnitSpec],
        fns: Dict[str, Optional[WorkFn]],
        engine: str,
        poll_interval: float,
        *,
        elastic: Sequence[ElasticEvent] = (),
        expected: int,
        default_fn: Optional[WorkFn] = None,
        backend: Optional[Union[str, BackendUnit]] = None,
        straggler: Optional[StragglerDetector] = None,
    ) -> RunReport:
        if engine == "interrupt":
            # Event-driven dispatch over real backend units: each unit's
            # chunks execute on its own backend (dedicated thread by
            # default), completions arrive on a condition variable, and
            # elastic membership changes apply between dispatches under
            # the tracked scheduler's lock.
            units = {
                s.name: make_backend(
                    backend if backend is not None else s.backend, s.name
                )
                for s in specs
            }
            eng = BackendEngine(
                sched, fns, units,
                expected=expected, elastic=elastic, default_fn=default_fn,
                join_backend=lambda ev: make_backend(
                    backend if not isinstance(backend, BackendUnit) else None,
                    ev.unit,
                ),
                straggler=straggler,
            )
            wall = eng.run()
            # "dead" (heartbeat conviction) is as much a loss as "lost"
            # (EOF): either way a unit departed with work requeued, so an
            # under-covered run must raise instead of reporting quietly.
            lost = any(ev.get("action") in ("lost", "dead")
                       for ev in eng.events)
            if (elastic or lost) and sched.items_done() < expected:
                raise RuntimeError(
                    f"run stalled: {sched.items_done()}/{expected} items "
                    "completed but every remaining unit departed or lost "
                    "its worker"
                )
            rep = _build_report(sched, wall, dispatch=eng.dispatch_latency(),
                                wire=eng.wire_latency(),
                                batch_frames=eng.frame_batching())
            if eng.events:
                rep.events = eng.events
        else:
            # "inline" is exactly the polling driver without the busy-wait
            # penalty: a deterministic serial round-robin on the caller
            # thread.
            interval = poll_interval if engine == "polling" else 0.0
            rep = PollingEngine(sched, fns, poll_interval=interval).run()
        rep.coverage = sched.coverage()
        return rep

    # -- sharded execution --------------------------------------------------
    def _run_sharded(
        self,
        space: ShardedSpace,
        specs: List[UnitSpec],
        fns: Dict[str, Optional[WorkFn]],
        work_fn: Optional[WorkFn],
        policy: str,
        engine: str,
        acc_chunk: int,
        item_cost: Optional[Sequence[float]],
        poll_interval: float,
        scheduler_kwargs: Optional[dict],
        elastic_events: List[ElasticEvent],
        backend: Optional[Union[str, BackendUnit]] = None,
        *,
        kernel: str = "default",
    ) -> RunReport:
        """One scheduler + engine per shard; merge into a global report.

        Shards model distinct hosts running concurrently, so the merged
        makespan is the *max* of shard makespans: under
        :class:`SimulatedClock` each shard replays on a private sub-clock
        from the same origin and the runtime clock advances by the
        slowest shard; on a wall clock interrupt/polling shards run on
        concurrent host threads while ``inline`` stays a deterministic
        sequential sweep.

        Unit placement: by default every shard gets a replica of the full
        unit set; a :attr:`~repro.core.space.ShardedSpace.placement`
        mapping instead *pins* units to their shard's scheduler — the
        multi-backend story, where a real device stream belongs to one
        host and must not be driven by two shard engines at once.
        Backend units are instantiated per shard, so each shard engine
        owns its workers outright.
        """
        simulated = isinstance(self.clock, SimulatedClock)
        shard_specs = self._place_units(space, specs)

        def shard_events(k: int) -> List[ElasticEvent]:
            # leaves only apply on shards that actually host the unit;
            # joins are fresh names and replicate onto every shard
            names = {s.name for s in shard_specs[k]}
            return [ev for ev in elastic_events
                    if ev.action == "join" or ev.unit in names]

        scheds: List[_TrackedScheduler] = []
        for k in range(space.num_shards):
            start, stop = space.shard_bounds(k)
            scheds.append(
                self._make_scheduler(
                    stop - start, shard_specs[k], policy, acc_chunk,
                    scheduler_kwargs, offset=start, kernel=kernel,
                )
            )

        reports: List[Optional[RunReport]] = [None] * space.num_shards
        if simulated:
            base = self.clock.now()
            for k, sched in enumerate(scheds):
                start, stop = space.shard_bounds(k)
                sub = SimulatedClock(base)
                reports[k] = self._run_simulated(
                    sched, shard_specs[k], dict(fns), engine, space.num_items,
                    item_cost, poll_interval, clock=sub,
                    elastic=shard_events(k), expected=stop - start,
                    default_fn=work_fn,
                )
            self.clock.advance(max(r.wall_time for r in reports))
        elif engine == "inline":
            for k, sched in enumerate(scheds):
                start, stop = space.shard_bounds(k)
                reports[k] = self._run_wall(
                    sched, shard_specs[k], fns, engine, poll_interval,
                    expected=stop - start,
                )
        else:
            errors: List[BaseException] = []

            def drive(k: int, sched: _TrackedScheduler) -> None:
                start, stop = space.shard_bounds(k)
                try:
                    reports[k] = self._run_wall(
                        sched, shard_specs[k], fns, engine, poll_interval,
                        elastic=shard_events(k), expected=stop - start,
                        default_fn=work_fn, backend=backend,
                    )
                except BaseException as exc:
                    errors.append(exc)

            threads = [
                threading.Thread(target=drive, args=(k, s), name=f"eneac-shard{k}")
                for k, s in enumerate(scheds)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        return _merge_shard_reports([r for r in reports if r is not None])

    @staticmethod
    def _place_units(
        space: ShardedSpace, specs: List[UnitSpec]
    ) -> List[List[UnitSpec]]:
        """Resolve which units run on which shard.

        Without a placement every shard replicates the full unit set
        (PR 3 semantics).  With one, pinned units appear only on their
        shard; unpinned units are still replicated everywhere.  A unit
        backed by a :class:`~repro.core.backends.BackendUnit` *instance*
        must be pinned — one real device stream cannot serve two
        concurrent shard engines.
        """
        placement = getattr(space, "placement", None) or {}
        unknown = sorted(set(placement) - {s.name for s in specs})
        if unknown:
            raise ValueError(f"placement pins unknown units {unknown}")
        for s in specs:
            if isinstance(s.backend, BackendUnit) and s.name not in placement:
                raise ValueError(
                    f"unit {s.name!r} has a concrete BackendUnit instance; "
                    "a ShardedSpace needs it pinned via placement="
                    "{unit: shard} so only one shard engine drives it"
                )
            if (isinstance(s.backend, str)
                    and s.backend.startswith("remote:")
                    and s.name not in placement):
                raise ValueError(
                    f"unit {s.name!r} is backed by remote worker "
                    f"{s.backend[len('remote:'):]!r} — one host; a "
                    "ShardedSpace needs it pinned via placement="
                    "{unit: shard} so only one shard engine drives it"
                )
        shard_specs = [
            [
                s for s in specs
                if placement.get(s.name, k) == k
            ]
            for k in range(space.num_shards)
        ]
        empty = [k for k, ss in enumerate(shard_specs) if not ss]
        if empty:
            raise ValueError(
                f"placement leaves shards {empty} without any units"
            )
        return shard_specs

    # -- virtual-time execution --------------------------------------------
    def _run_simulated(
        self,
        sched: _TrackedScheduler,
        specs: List[UnitSpec],
        fns: Dict[str, Optional[WorkFn]],
        engine: str,
        num_items: int,
        item_cost: Optional[Sequence[float]],
        poll_interval: float,
        *,
        clock: SimulatedClock,
        elastic: Optional[List[ElasticEvent]] = None,
        expected: Optional[int] = None,
        default_fn: Optional[WorkFn] = None,
    ) -> RunReport:
        t0 = clock.now()
        # event times are run-relative; rebase onto this run's clock origin
        # so a reused runtime (clock already advanced) behaves identically
        elastic = [
            ElasticEvent(t=t0 + ev.t, action=ev.action, unit=ev.unit,
                         kind=ev.kind, speed=ev.speed)
            for ev in (elastic or [])
        ]
        expected = num_items if expected is None else expected
        # prefix sums so irregular per-item costs price a chunk in O(1);
        # chunks carry global indices, so the prefix spans the full space
        if item_cost is not None:
            prefix = [0.0]
            for c in item_cost:
                prefix.append(prefix[-1] + float(c))
        else:
            prefix = None
        speeds = {s.name: (1.0 if s.speed is None else s.speed) for s in specs}
        report_events: List[dict] = []

        def cost(chunk: Chunk) -> float:
            work = (
                prefix[chunk.stop] - prefix[chunk.start]
                if prefix is not None
                else float(chunk.size)
            )
            return work / max(speeds[chunk.worker], 1e-12)

        def do_join(ev: ElasticEvent) -> None:
            sched.add_unit(ev.unit, ev.kind, throughput=ev.speed)
            speeds[ev.unit] = 1.0 if ev.speed is None else ev.speed
            fns[ev.unit] = default_fn
            report_events.append(
                {"t": clock.now() - t0, "action": "join", "unit": ev.unit,
                 "requeued": None}
            )

        def do_leave(ev: ElasticEvent) -> Optional[Chunk]:
            inflight = sched.remove_unit(ev.unit)
            report_events.append(
                {"t": clock.now() - t0, "action": "leave", "unit": ev.unit,
                 "requeued": (inflight.start, inflight.stop) if inflight else None}
            )
            return inflight

        if engine == "interrupt":
            self._simulate_interrupt(
                sched, specs, fns, clock, cost, elastic, do_join, do_leave,
                expected,
            )
        else:
            self._simulate_serial(
                sched, specs, fns, clock, cost, elastic, do_join, do_leave,
                engine, poll_interval, expected,
            )
        if elastic and sched.items_done() < expected:
            raise RuntimeError(
                f"elastic run stalled: {sched.items_done()}/{expected} items "
                "completed but every remaining unit departed"
            )
        report = _build_report(sched, clock.now() - t0)
        if report_events:
            report.events = report_events
        return report

    def _simulate_interrupt(
        self, sched, specs, fns, clock, cost, elastic, do_join, do_leave,
        expected: int,
    ) -> None:
        """Event-driven replay: units progress concurrently in virtual time.

        The heap carries both chunk completions and elastic membership
        events; a leave cancels the departed unit's pending completion
        (its chunk is requeued by the tracked scheduler) and wakes idle
        survivors, a join dispatches the new unit immediately.  Work
        functions run at chunk *completion*, so a chunk requeued by a
        leave has its side effects recorded exactly once — by whichever
        unit finally completes it.  Membership events timed after the
        space is fully covered are dropped: they belong to no run, and
        advancing the clock to them would corrupt the makespan.
        """
        heap: List[Tuple[float, int, int, object]] = []
        seq = 0
        inflight: Dict[str, int] = {}
        cancelled: set = set()
        _EVENT, _DONE = 0, 1

        def dispatch(name: str) -> None:
            nonlocal seq
            chunk = sched.next_chunk(name, now=clock.now())
            if chunk is None:
                return
            dt = cost(chunk)
            heapq.heappush(heap, (clock.now() + dt, seq, _DONE, (name, chunk, dt)))
            inflight[name] = seq
            seq += 1

        for ev in elastic:
            # membership events sort before completions at the same instant
            heapq.heappush(heap, (ev.t, seq, _EVENT, ev))
            seq += 1
        for s in specs:
            dispatch(s.name)

        while heap:
            t, entry_seq, tag, payload = heapq.heappop(heap)
            if tag == _DONE:
                if entry_seq in cancelled:
                    cancelled.discard(entry_seq)
                    continue
                name, chunk, dt = payload
                clock.advance(max(t - clock.now(), 0.0))
                inflight.pop(name, None)
                sched.complete(name, dt)
                if fns.get(name) is not None:
                    fns[name](chunk)
                dispatch(name)
            else:
                if sched.items_done() >= expected:
                    continue  # run already over; stale membership event
                clock.advance(max(t - clock.now(), 0.0))
                if payload.action == "leave":
                    do_leave(payload)
                    pending = inflight.pop(payload.unit, None)
                    if pending is not None:
                        cancelled.add(pending)
                    # idle survivors can pick up the requeued span now
                    removed = sched.removed
                    for n, st in sched.workers.items():
                        if not st.busy and n not in removed:
                            dispatch(n)
                else:
                    do_join(payload)
                    dispatch(payload.unit)

    def _simulate_serial(
        self, sched, specs, fns, clock, cost, elastic, do_join, do_leave,
        engine: str, poll_interval: float, expected: int,
    ) -> None:
        """Serial replay (polling/inline): one virtual driver thread.

        Chunk execution is atomic on the driver, so membership changes
        take effect at dispatch boundaries — a leave never strands an
        in-flight chunk here; it requeues the unit's uncollected
        pre-split assignment (if any) and removes it from the rotation.
        """
        pending = list(elastic)  # already time-sorted
        names = [s.name for s in specs]

        def process_due() -> None:
            while pending and pending[0].t <= clock.now() + 1e-15:
                ev = pending.pop(0)
                if ev.action == "leave":
                    do_leave(ev)
                    if ev.unit in names:
                        names.remove(ev.unit)
                else:
                    do_join(ev)
                    names.append(ev.unit)

        while True:
            process_due()
            issued_any = False
            for name in list(names):
                if name not in names:
                    continue
                chunk = sched.next_chunk(name, now=clock.now())
                if chunk is None:
                    continue
                issued_any = True
                if fns.get(name) is not None:
                    fns[name](chunk)
                dt = cost(chunk)
                clock.advance(dt)
                if engine == "polling" and poll_interval:
                    clock.advance(poll_interval)
                sched.complete(name, dt)
                process_due()
            if not issued_any:
                if pending and sched.items_done() < expected:
                    # idle until the next membership event (e.g. a join
                    # that will pick up requeued work); events timed after
                    # full coverage are dropped, not waited for
                    clock.advance(max(pending[0].t - clock.now(), 0.0))
                    process_due()
                    continue
                break


def _merge_shard_reports(reports: List[RunReport]) -> RunReport:
    """Fold per-shard reports into one global RunReport.

    Shards are concurrent hosts: merged makespan is the slowest shard;
    per-unit maps are namespaced ``s{shard}/{unit}``; coverage is the
    sorted union of shard coverages (still an exact tiling of the global
    space); ``load_balance`` spans every unit of every shard, while
    :attr:`RunReport.cross_shard_balance` compares whole shards.
    """
    if not reports:
        raise ValueError("no shard reports to merge")
    per_items: Dict[str, int] = {}
    per_chunks: Dict[str, int] = {}
    per_busy: Dict[str, float] = {}
    per_dispatch: Dict[str, float] = {}
    per_wire: Dict[str, float] = {}
    per_batch: Dict[str, int] = {}
    coverage: List[tuple] = []
    events: List[dict] = []
    for k, rep in enumerate(reports):
        for n, v in rep.per_worker_items.items():
            per_items[f"s{k}/{n}"] = v
        for n, v in rep.per_worker_chunks.items():
            per_chunks[f"s{k}/{n}"] = v
        for n, v in rep.per_worker_busy.items():
            per_busy[f"s{k}/{n}"] = v
        for n, v in (rep.dispatch_latency or {}).items():
            per_dispatch[f"s{k}/{n}"] = v
        for n, v in (rep.wire_latency or {}).items():
            per_wire[f"s{k}/{n}"] = v
        for n, v in (rep.batch_frames or {}).items():
            per_batch[f"s{k}/{n}"] = v
        coverage.extend(rep.coverage or [])
        for ev in rep.events or []:
            events.append({**ev, "unit": f"s{k}/{ev['unit']}", "shard": k})
    busy = [b for n, b in per_busy.items() if per_chunks.get(n)]
    mean = sum(busy) / len(busy) if busy else 0.0
    return RunReport(
        wall_time=max(r.wall_time for r in reports),
        items=sum(r.items for r in reports),
        chunks=sum(r.chunks for r in reports),
        per_worker_items=per_items,
        per_worker_chunks=per_chunks,
        per_worker_busy=per_busy,
        load_balance=(max(busy) / max(mean, 1e-12)) if busy else 1.0,
        coverage=sorted(coverage),
        events=events or None,
        shard_reports=list(reports),
        dispatch_latency=per_dispatch or None,
        wire_latency=per_wire or None,
        batch_frames=per_batch or None,
    )

"""Fleet membership: discovery, heartbeat liveness, autoscaling, recovery.

The port's copy of ``repro.core.fleet``.  What differs: a
:class:`FleetManager`'s workers host ``cuda`` units unless it is built
with another ``remote_backend``, and its workers are the port's
:func:`~repro_torch.core.transport.spawn_worker` processes.

The paper's scheduler assumes a *known* set of compute units.  This
module owns the step before that assumption holds: which workers are in
the fleet right now, which of them are still alive, and how many there
should be.

* :class:`HeartbeatBook` — the membership ledger.  Workers announce
  (``join``), then report liveness (``beat``, fed from the transport's
  ``heartbeat`` frames); a member silent for longer than
  ``patience x heartbeat`` is *convicted* dead on the next :meth:`sweep`.
  The patience gate mirrors :class:`~repro_torch.core.straggler.StragglerDetector`:
  one missed beat is weather, ``patience`` consecutive missed beats is a
  verdict.  Every membership change lands in a monotone event log.
* :class:`Autoscaler` — a pure sizing policy: observed queue depth plus
  the cost model's learned per-unit throughput
  (:meth:`~repro_torch.core.costmodel.CostModel.predict_drain`) give the
  smallest fleet that drains the backlog within ``horizon`` seconds.
  Scale-up covers the whole gap at once (backlog hurts now); scale-down
  drains one unit per cooldown (capacity is cheap to keep, expensive to
  rebuild).  With no learned data the policy holds size — it never
  scales blind.
* :class:`FailureTrace` / :func:`simulate_fleet` — seeded churn
  (join/leave/crash/slow) replayed two ways: virtual heartbeat timelines
  through a :class:`HeartbeatBook` (conviction correctness: every crash
  convicted, no slow-but-alive unit convicted), then the derived
  membership timeline through
  :meth:`~repro_torch.core.runtime.HeteroRuntime.parallel_for` under
  :class:`~repro_torch.core.runtime.SimulatedClock` (exact-once coverage under
  churn).  Deterministic per seed — the CI battery replays many seeds.
* :class:`FleetManager` — the wall-clock owner: spawns
  :func:`~repro_torch.core.transport.spawn_worker` subprocesses, registers
  them as ``remote:<addr>?heartbeat=..&patience=..&backend=..`` units (so the
  transport layer's missed-heartbeat conviction feeds the engine's
  retire path), and applies :class:`Autoscaler` decisions to real
  processes.  Mid-run worker death is the transport/engine's job
  (``action="lost"``/``"dead"`` + exact-once requeue); whole-run death
  is :func:`repro_torch.checkpoint.coverage.checkpointed_parallel_for`'s.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .costmodel import CostModel
from .elastic import ElasticSchedule
from .transport import WorkerHandle, spawn_worker

__all__ = [
    "Autoscaler",
    "FailureTrace",
    "FleetManager",
    "FleetSimResult",
    "HeartbeatBook",
    "TraceEvent",
    "simulate_fleet",
]


# ---------------------------------------------------------------------------
# membership ledger
# ---------------------------------------------------------------------------
@dataclass
class _Member:
    name: str
    last_heard: float
    queue_depth: int = 0
    inflight: int = 0


class HeartbeatBook:
    """Patience-gated membership ledger over explicit timestamps.

    Time is an argument, not a clock read, so the same book serves the
    wall-clock :class:`FleetManager` (pass ``time.perf_counter()``) and
    the seeded virtual-time simulation (pass trace times) — and every
    conviction decision is replayable.

    Timestamps must be non-decreasing across *all* calls; the book
    raises on time travel rather than producing an unorderable event
    log.  Events are dicts ``{"t", "action", "unit"}`` with action in
    ``join | leave | dead``, appended in call order — monotone ``t`` is
    an invariant the fleet battery pins per seed.
    """

    def __init__(self, *, heartbeat: float, patience: int = 3) -> None:
        if heartbeat <= 0:
            raise ValueError(f"heartbeat must be positive, got {heartbeat}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.heartbeat = float(heartbeat)
        self.patience = int(patience)
        self._members: Dict[str, _Member] = {}
        self._events: List[dict] = []
        self._now = 0.0

    # -- invariants ---------------------------------------------------------
    def _advance(self, t: float) -> float:
        t = float(t)
        if t < self._now:
            raise ValueError(
                f"time went backwards: {t} < last seen {self._now}"
            )
        self._now = t
        return t

    # -- membership feed ----------------------------------------------------
    def join(self, t: float, unit: str) -> None:
        t = self._advance(t)
        if unit in self._members:
            raise ValueError(f"unit {unit!r} is already a member")
        self._members[unit] = _Member(name=unit, last_heard=t)
        self._events.append({"t": t, "action": "join", "unit": unit})

    def beat(self, t: float, unit: str, *, queue_depth: int = 0,
             inflight: int = 0) -> None:
        """A liveness report (the transport's ``heartbeat`` frame payload).

        Beats from non-members are dropped, not an error: a convicted
        worker's in-flight beats may still arrive after the sweep, and a
        late beat must not resurrect a membership the engine has already
        retired.
        """
        t = self._advance(t)
        m = self._members.get(unit)
        if m is None:
            return
        m.last_heard = t
        m.queue_depth = int(queue_depth)
        m.inflight = int(inflight)

    def leave(self, t: float, unit: str) -> None:
        """A graceful departure (the transport's ``bye``)."""
        t = self._advance(t)
        if unit not in self._members:
            raise ValueError(f"unit {unit!r} is not a member")
        del self._members[unit]
        self._events.append({"t": t, "action": "leave", "unit": unit})

    def sweep(self, t: float) -> List[str]:
        """Convict every member silent for more than patience x heartbeat.

        Returns the convicted names (event ``action="dead"``, matching
        the engine's silence-vs-loss distinction) in name order.
        """
        t = self._advance(t)
        limit = self.patience * self.heartbeat
        dead = sorted(
            name for name, m in self._members.items()
            if (t - m.last_heard) > limit
        )
        for name in dead:
            del self._members[name]
            self._events.append({"t": t, "action": "dead", "unit": name})
        return dead

    # -- views --------------------------------------------------------------
    @property
    def members(self) -> List[str]:
        return sorted(self._members)

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def queue_depth(self) -> int:
        """Total reported backlog across live members (autoscaler input)."""
        return sum(m.queue_depth for m in self._members.values())

    def deadline(self, unit: str) -> float:
        """The time at which ``unit`` becomes convictable."""
        m = self._members.get(unit)
        if m is None:
            raise KeyError(unit)
        return m.last_heard + self.patience * self.heartbeat

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, unit: str) -> bool:
        return unit in self._members


# ---------------------------------------------------------------------------
# sizing policy
# ---------------------------------------------------------------------------
class Autoscaler:
    """Queue-depth + learned-throughput fleet sizing.

    Pure policy: :meth:`decide` maps ``(t, queue_depth, n_units)`` to a
    signed membership delta; applying it (spawning/draining) is the
    caller's job (:class:`FleetManager` on a wall clock, the simulation
    in virtual time).  The target size is the smallest fleet whose
    predicted drain time (:meth:`CostModel.predict_drain`) fits inside
    ``horizon`` seconds, clamped to ``[min_units, max_units]``.

    Asymmetry is deliberate: scale-up closes the whole gap in one step
    (an over-deep queue is the failure mode the paper's async engine
    exists to avoid), scale-down releases one unit per ``cooldown_s``
    (readmitting capacity costs a worker spawn + handshake).  A model
    with no observations for ``kernel`` yields delta 0 — never scale on
    a guess.
    """

    def __init__(
        self,
        cost_model: Optional[CostModel] = None,
        *,
        kernel: str = "default",
        horizon: float = 1.0,
        min_units: int = 1,
        max_units: int = 8,
        cooldown_s: float = 1.0,
    ) -> None:
        if horizon <= 0:
            raise ValueError(f"horizon must be positive, got {horizon}")
        if min_units < 1:
            raise ValueError(f"min_units must be >= 1, got {min_units}")
        if max_units < min_units:
            raise ValueError(
                f"max_units {max_units} < min_units {min_units}"
            )
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.cost_model = cost_model
        self.kernel = kernel
        self.horizon = float(horizon)
        self.min_units = int(min_units)
        self.max_units = int(max_units)
        self.cooldown_s = float(cooldown_s)
        self._last_change: Optional[float] = None

    def target(self, queue_depth: int) -> Optional[int]:
        """Clamped ideal size, or None when the model has no data."""
        if queue_depth <= 0:
            return self.min_units
        if self.cost_model is None:
            return None
        per_unit = self.cost_model.fleet_throughput(self.kernel)
        if per_unit is None:
            return None
        need = math.ceil(queue_depth / (per_unit * self.horizon))
        return max(self.min_units, min(self.max_units, need))

    def decide(self, t: float, *, queue_depth: int, n_units: int) -> int:
        """Signed unit delta to apply now (0 = hold)."""
        tgt = self.target(queue_depth)
        if tgt is None or tgt == n_units:
            return 0
        if self._last_change is not None and \
                (t - self._last_change) < self.cooldown_s:
            return 0
        delta = (tgt - n_units) if tgt > n_units else -1
        # never drain below the floor even if n_units started above max
        if delta < 0 and n_units + delta < self.min_units:
            return 0
        self._last_change = t
        return delta


# ---------------------------------------------------------------------------
# seeded churn traces
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TraceEvent:
    """One membership fate in a seeded churn trace.

    ``action`` is ``join`` (a fresh unit announces at ``t``), ``leave``
    (graceful bye at ``t``), ``crash`` (goes silent at ``t``: heartbeats
    stop, no bye), or ``slow`` (from ``t`` on, beats arrive stretched by
    ``factor`` < patience — alive, just late; a correct book never
    convicts it).
    """

    t: float
    action: str
    unit: str
    factor: float = 1.0

    def __post_init__(self) -> None:
        if self.action not in ("join", "leave", "crash", "slow"):
            raise ValueError(f"unknown trace action {self.action!r}")
        if self.t < 0:
            raise ValueError(f"event time must be >= 0, got {self.t}")


class FailureTrace:
    """A seeded, replayable churn timeline over an initial fleet."""

    def __init__(self, seed: int, initial_units: Sequence[str],
                 events: Sequence[TraceEvent], horizon: float) -> None:
        self.seed = int(seed)
        self.initial_units = list(initial_units)
        self.events = sorted(events, key=lambda e: e.t)
        self.horizon = float(horizon)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        num_units: int = 100,
        horizon: float = 10.0,
        crash_frac: float = 0.15,
        leave_frac: float = 0.10,
        slow_frac: float = 0.15,
        join_frac: float = 0.10,
    ) -> "FailureTrace":
        """Deterministic churn for ``seed``: each initial unit draws one
        fate (stay / leave / crash / slow) and ``join_frac`` fresh units
        announce mid-run.  Fractions are bounded so a majority of the
        fleet always survives — total loss is a different failure mode
        (job abort), not elasticity.
        """
        if num_units < 2:
            raise ValueError(f"need at least 2 units, got {num_units}")
        if crash_frac + leave_frac > 0.5:
            raise ValueError(
                "crash_frac + leave_frac must stay <= 0.5 so survivors "
                f"remain a majority, got {crash_frac + leave_frac}"
            )
        rng = random.Random(seed)
        units = [f"u{i:03d}" for i in range(num_units)]
        fates = (["crash"] * int(num_units * crash_frac)
                 + ["leave"] * int(num_units * leave_frac)
                 + ["slow"] * int(num_units * slow_frac))
        fates += ["stay"] * (num_units - len(fates))
        rng.shuffle(fates)
        events: List[TraceEvent] = []
        for unit, fate in zip(units, fates):
            if fate == "stay":
                continue
            # churn lands mid-run: not at t=0 (that's just a smaller
            # fleet) and not at the horizon (those events are no-ops)
            t = rng.uniform(0.1, 0.9) * horizon
            if fate == "slow":
                # stretched but under the conviction limit: a correct
                # book must keep these (the straggler layer's problem)
                factor = rng.uniform(1.2, 2.4)
                events.append(TraceEvent(t=t, action="slow", unit=unit,
                                         factor=factor))
            else:
                events.append(TraceEvent(t=t, action=fate, unit=unit))
        for j in range(int(num_units * join_frac)):
            t = rng.uniform(0.1, 0.9) * horizon
            events.append(TraceEvent(t=t, action="join", unit=f"j{j:03d}"))
        return cls(seed, units, events, horizon)

    def fate_of(self, unit: str) -> Optional[TraceEvent]:
        for ev in self.events:
            if ev.unit == unit:
                return ev
        return None

    @property
    def crashed(self) -> List[str]:
        return sorted(e.unit for e in self.events if e.action == "crash")

    @property
    def left(self) -> List[str]:
        return sorted(e.unit for e in self.events if e.action == "leave")

    @property
    def slowed(self) -> List[str]:
        return sorted(e.unit for e in self.events if e.action == "slow")

    @property
    def joined(self) -> List[str]:
        return sorted(e.unit for e in self.events if e.action == "join")


# ---------------------------------------------------------------------------
# virtual-time fleet simulation
# ---------------------------------------------------------------------------
@dataclass
class FleetSimResult:
    """What one seeded replay produced — everything the battery asserts."""

    seed: int
    trace: FailureTrace
    book_events: List[dict]
    convicted: List[str]
    false_convictions: List[str]
    missed_crashes: List[str]
    conviction_delay: Dict[str, float]
    schedule: ElasticSchedule
    report: object  # RunReport; untyped to keep the import graph acyclic
    survivors: List[str] = field(default_factory=list)


def simulate_fleet(
    seed: int,
    *,
    num_units: int = 100,
    heartbeat: float = 0.05,
    patience: int = 3,
    horizon: float = 10.0,
    items_per_unit: int = 6,
    trace: Optional[FailureTrace] = None,
) -> FleetSimResult:
    """Replay one seeded churn trace through the whole membership stack.

    Phase 1 — liveness: every unit's heartbeat timeline (stopping at its
    crash, ending with a bye at its leave, stretching by its slow
    factor) is fed through a :class:`HeartbeatBook` in global time
    order, sweeping at every step.  Convictions are compared against the
    trace's ground truth: ``false_convictions`` (convicted but alive —
    must be empty: slow is not dead) and ``missed_crashes`` (crashed but
    never convicted before the horizon — must be empty: silence is
    always noticed).

    Phase 2 — coverage: the book's verdicts become an
    :class:`~repro_torch.core.elastic.ElasticSchedule` (graceful leaves at
    their bye times, crashes at their *conviction* times — detection
    latency included — merged with trace joins), replayed by
    ``parallel_for`` under :class:`SimulatedClock` so the engine's
    exact-once requeue is exercised under the same churn.  The caller
    asserts the report's coverage tiles the space exactly and its event
    log is time-monotone.
    """
    # local import: runtime imports backends/transport; fleet is imported
    # by core/__init__ after runtime, so a module-level import would cycle
    from .runtime import HeteroRuntime, SimulatedClock

    tr = trace if trace is not None else FailureTrace.generate(
        seed, num_units=num_units, horizon=horizon)
    book = HeartbeatBook(heartbeat=heartbeat, patience=patience)

    # -- phase 1: virtual heartbeat timelines --------------------------------
    # (t, order, kind, unit, payload); order breaks ties deterministically
    feed: List[Tuple[float, int, str, str, float]] = []
    order = 0

    def emit(t: float, kind: str, unit: str, payload: float = 0.0) -> None:
        nonlocal order
        feed.append((t, order, kind, unit, payload))
        order += 1

    for unit in tr.initial_units:
        emit(0.0, "join", unit)
    for ev in tr.events:
        if ev.action == "join":
            emit(ev.t, "join", ev.unit)

    for unit in tr.initial_units + tr.joined:
        fate = tr.fate_of(unit)
        start = fate.t if (fate is not None and fate.action == "join") else 0.0
        stop = tr.horizon
        interval = heartbeat
        if fate is not None and fate.action in ("crash", "leave"):
            stop = fate.t
        t = start + interval
        while t < stop:
            if fate is not None and fate.action == "slow" and t >= fate.t:
                interval = heartbeat * fate.factor
            emit(t, "beat", unit)
            t += interval
        if fate is not None and fate.action == "leave":
            emit(fate.t, "bye", unit)

    convicted: List[str] = []
    conviction_t: Dict[str, float] = {}
    for t, _, kind, unit, _payload in sorted(feed, key=lambda e: (e[0], e[1])):
        if kind == "join":
            book.join(t, unit)
        elif kind == "beat":
            book.beat(t, unit)
        elif kind == "bye":
            book.leave(t, unit)
        for name in book.sweep(t):
            convicted.append(name)
            conviction_t[name] = t
    for name in book.sweep(tr.horizon):
        convicted.append(name)
        conviction_t[name] = tr.horizon

    crashed = set(tr.crashed)
    false_convictions = sorted(set(convicted) - crashed)
    missed_crashes = sorted(crashed - set(convicted))
    delays = {u: conviction_t[u] - float(tr.fate_of(u).t)
              for u in crashed if u in conviction_t}

    # -- phase 2: membership timeline under the real engine ------------------
    losses = ElasticSchedule()
    for ev in tr.events:
        if ev.action == "leave":
            losses.leave(ev.t, ev.unit)
        elif ev.action == "crash" and ev.unit in conviction_t:
            # the engine learns of a crash at *conviction*, not at the
            # instant of death — detection latency is part of the model
            losses.leave(conviction_t[ev.unit], ev.unit)
    joins = ElasticSchedule()
    for ev in tr.events:
        if ev.action == "join":
            joins.join(ev.t, ev.unit, kind="cc", speed=1.0)
    schedule = losses.merge(joins)

    rt = HeteroRuntime(clock=SimulatedClock())
    for unit in tr.initial_units:
        fate = tr.fate_of(unit)
        speed = 1.0
        if fate is not None and fate.action == "slow":
            speed = 1.0 / fate.factor
        rt.register_unit(unit, "cc", speed=speed)
    report = rt.parallel_for(
        num_items=num_units * items_per_unit,
        policy="multidynamic",
        acc_chunk=max(items_per_unit // 2, 1),
        elastic=schedule,
    )

    return FleetSimResult(
        seed=seed,
        trace=tr,
        book_events=book.events,
        convicted=sorted(set(convicted)),
        false_convictions=false_convictions,
        missed_crashes=missed_crashes,
        conviction_delay=delays,
        schedule=schedule,
        report=report,
        survivors=book.members,
    )


# ---------------------------------------------------------------------------
# wall-clock fleet
# ---------------------------------------------------------------------------
class FleetManager:
    """Owns real worker subprocesses and their runtime registrations.

    ``scale_to(n)`` / ``autoscale_step()`` spawn
    :func:`~repro_torch.core.transport.spawn_worker` processes and register
    each as a ``remote:<addr>?heartbeat=..&patience=..&backend=..`` unit
    on the runtime (hosting ``remote_backend``, ``"cuda"`` unless given),
    so every fleet member gets transport-level liveness: a
    silent worker is convicted by its :class:`RemoteUnit` proxy and
    retired through the engine's elastic path (``action="dead"``,
    exact-once requeue) without any fleet-level polling.

    Draining removes the registration first and then terminates the
    process — the reverse order would turn every scale-down into a fake
    worker-loss event.  Use as a context manager; :meth:`shutdown` is
    idempotent.
    """

    def __init__(
        self,
        runtime,
        *,
        heartbeat: float = 0.5,
        patience: int = 3,
        autoscaler: Optional[Autoscaler] = None,
        unit_prefix: str = "fleet",
        spawn: Callable[[], WorkerHandle] = spawn_worker,
        remote_backend: str = "cuda",
    ) -> None:
        if heartbeat <= 0:
            raise ValueError(f"heartbeat must be positive, got {heartbeat}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.runtime = runtime
        self.heartbeat = float(heartbeat)
        self.patience = int(patience)
        self.autoscaler = autoscaler
        self.unit_prefix = unit_prefix
        self._spawn = spawn
        self.remote_backend = remote_backend
        self._handles: Dict[str, WorkerHandle] = {}
        self._next_id = 0
        self._events: List[dict] = []

    # -- membership ---------------------------------------------------------
    def spec_for(self, handle: WorkerHandle) -> str:
        return (f"remote:{handle.address}"
                f"?heartbeat={self.heartbeat}&patience={self.patience}"
                f"&backend={self.remote_backend}")

    def spawn_unit(self) -> str:
        """One worker subprocess -> one registered heartbeat-proxied unit."""
        handle = self._spawn()
        name = f"{self.unit_prefix}{self._next_id}"
        self._next_id += 1
        try:
            self.runtime.register_unit(name, "cc",
                                       backend=self.spec_for(handle))
        except Exception:
            handle.terminate()
            raise
        self._handles[name] = handle
        self._events.append({"t": time.perf_counter(), "action": "join",
                             "unit": name})
        return name

    def drain_unit(self, name: str) -> None:
        """Graceful scale-down: deregister, then terminate the process."""
        handle = self._handles.pop(name, None)
        if handle is None:
            raise KeyError(f"unknown fleet unit {name!r}")
        self.runtime.deregister_unit(name)
        handle.terminate()
        self._events.append({"t": time.perf_counter(), "action": "leave",
                             "unit": name})

    def kill_unit(self, name: str) -> None:
        """SIGKILL the worker but keep its registration — the crash is
        for the transport/engine layers to detect and retire.  Fault
        injection for tests, mostly."""
        handle = self._handles.get(name)
        if handle is None:
            raise KeyError(f"unknown fleet unit {name!r}")
        handle.kill()
        self._events.append({"t": time.perf_counter(), "action": "kill",
                             "unit": name})

    def reap(self) -> List[str]:
        """Deregister members whose process already exited (killed or
        crashed on their own).  Returns the reaped names."""
        gone = sorted(n for n, h in self._handles.items() if not h.alive)
        for name in gone:
            self._handles.pop(name)
            self.runtime.deregister_unit(name)
            self._events.append({"t": time.perf_counter(), "action": "dead",
                                 "unit": name})
        return gone

    def scale_to(self, n: int) -> List[str]:
        """Spawn or drain until the fleet has exactly ``n`` members.
        Returns the names touched.  Drains retire the newest members
        first (oldest members have the warmest caches)."""
        if n < 0:
            raise ValueError(f"fleet size must be >= 0, got {n}")
        touched: List[str] = []
        while len(self._handles) < n:
            touched.append(self.spawn_unit())
        for name in sorted(self._handles, reverse=True)[:len(self._handles) - n]:
            self.drain_unit(name)
            touched.append(name)
        return touched

    def autoscale_step(self, queue_depth: int,
                       now: Optional[float] = None) -> int:
        """One policy tick: ask the attached :class:`Autoscaler` for a
        delta at the observed ``queue_depth`` and apply it.  Returns the
        applied delta (0 without an autoscaler or on hold)."""
        if self.autoscaler is None:
            return 0
        t = time.perf_counter() if now is None else now
        delta = self.autoscaler.decide(t, queue_depth=queue_depth,
                                       n_units=len(self._handles))
        if delta:
            self.scale_to(len(self._handles) + delta)
        return delta

    # -- views & lifecycle --------------------------------------------------
    @property
    def members(self) -> List[str]:
        return sorted(self._handles)

    @property
    def events(self) -> List[dict]:
        return list(self._events)

    def handle(self, name: str) -> WorkerHandle:
        return self._handles[name]

    def __len__(self) -> int:
        return len(self._handles)

    def shutdown(self) -> None:
        for name in sorted(self._handles):
            handle = self._handles.pop(name)
            try:
                self.runtime.deregister_unit(name)
            except KeyError:
                pass
            handle.terminate()

    def __enter__(self) -> "FleetManager":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

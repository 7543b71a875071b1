"""Backend units: genuine asynchronous dispatch for wall-clock runs.

Before this module, a :class:`~repro.core.runtime.WallClock` run executed
every ``work_fn`` *inside* the engine's own threads — asynchrony was an
artifact of how :class:`~repro.core.interrupts.AsyncEngine` was written,
not a property of the compute units.  The paper's model (and HEROv2's
runtime) is the opposite: each heterogeneous processing unit is a real
execution resource with its own stream, the host *submits* work to it and
is told — asynchronously — when the unit finishes.  This module reifies
that boundary:

* :class:`BackendUnit` — the protocol: ``start(bus)`` /
  ``submit(chunk, work_fn)`` (non-blocking, future-style: completion is
  delivered to the run's :class:`CompletionBus`) / ``close()``.
* :class:`InlineUnit` — synchronous execution on the dispatcher thread
  (the degenerate backend: useful as a baseline for dispatch overhead and
  for deterministic engine tests).
* :class:`ThreadUnit` — one dedicated worker thread per unit, modelling a
  CPU core (the paper's CC).  The default wall-clock backend.
* :class:`ProcessPoolUnit` — a single-worker process pool, modelling a
  separate CPU (no GIL sharing).  Work functions must be picklable.
* :class:`CudaStreamUnit` — runs the work function under a dedicated
  ``torch.cuda.Stream``: kernel launches return immediately and a waiter
  thread turns ``event.synchronize()`` into the completion signal.  It
  raises without CUDA unless it was built with ``device="cpu"``.
* :class:`~repro_torch.core.transport.RemoteUnit` (in
  :mod:`repro_torch.core.transport`) — the same protocol stretched across
  a process/host boundary: submits become frames on a transport, and a
  worker connection drop surfaces as a :class:`WorkerLost` completion the
  engine answers by requeueing the in-flight chunk.
* :class:`BackendEngine` — the event-driven dispatcher the runtime's
  ``_run_wall`` builds on: one loop thread hands each idle backend a
  chunk the moment it goes idle, completions arrive on a condition
  variable from the backends' real threads, and
  :class:`~repro.core.elastic.ElasticSchedule` join/leave events are
  applied mid-run under the tracked scheduler's lock so the exact-once
  coverage invariant holds under real concurrency.

Elastic semantics under a wall clock differ from the simulated abort
model in one deliberate way: a **leave retires the unit** — it stops
receiving chunks at the event time, but an in-flight chunk *completes
and counts*, because real device work cannot be recalled mid-stream.
(Under :class:`~repro.core.runtime.SimulatedClock` a leave models an
instantaneous FPGA reprogram: the in-flight chunk is requeued.)  A
departing unit's never-issued pre-split assignment is still drained
into the requeue buffer and served to survivors, and a joining unit is
given a fresh backend and starts stealing immediately — so work-function
side effects happen exactly once per index even under churn, which is
what `tests/test_backends.py` pins across randomized schedules.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .elastic import ElasticEvent
from .scheduler import Chunk

__all__ = [
    "BackendUnit",
    "CompletionBus",
    "CompletionRecord",
    "InlineUnit",
    "ThreadUnit",
    "ProcessPoolUnit",
    "CudaStreamUnit",
    "WorkerLost",
    "WorkerDead",
    "BackendEngine",
    "BACKENDS",
    "make_backend",
]

WorkFn = Callable[[Chunk], Any]

BACKENDS = ("inline", "thread", "process", "cuda", "remote")

# The full spec grammar, quoted once so every "unknown backend" error can
# list it (tests pin this — an unknown spec must teach the valid ones).
VALID_BACKEND_SPECS = (
    "'inline'", "'thread'/'threads'", "'process'/'processes'", "'cuda'",
    "'remote:<host:port>' (optional '?batch_frames=N&fn_cache=0|1"
    "&heartbeat=SECS&patience=N&backend=KIND' suffix)",
)

# Dispatch fast-path and liveness knobs accepted in a remote spec's
# query string.  ``heartbeat`` (float seconds) asks the worker for
# periodic liveness frames; ``patience`` is how many missed intervals
# convict the worker as dead; ``backend`` names the unit the worker hosts
# ("thread" unless given; "cuda" for a CudaStreamUnit on the worker's card).
REMOTE_SPEC_KNOBS = ("batch_frames", "fn_cache", "heartbeat", "patience", "backend")


class WorkerLost(ConnectionError):
    """A unit's execution medium died with a chunk possibly in flight.

    Posted as a :class:`CompletionRecord` error by transport-backed units
    (:class:`~repro.core.transport.RemoteUnit`) when the connection to
    their worker drops or retransmits are exhausted.  Unlike a work-
    function error — which fails the run — a lost worker is a *membership*
    event: :class:`BackendEngine` removes the unit and requeues its
    in-flight chunk to the survivors exactly once, the same path an
    elastic leave takes.
    """


class WorkerDead(WorkerLost):
    """Missed-heartbeat conviction: the worker went *silent*, it did not
    visibly drop the connection.

    Posted by a heartbeat-enabled :class:`~repro.core.transport.RemoteUnit`
    when the worker has sent nothing (heartbeats included) for
    ``patience`` intervals — the membership ledger's verdict, as opposed
    to the definitive EOF behind a plain :class:`WorkerLost`.  The engine
    handles both identically (remove + exact-once requeue) but records
    ``action="dead"`` instead of ``action="lost"`` so a report
    distinguishes silence from loss mid-chunk.
    """


@dataclass
class CompletionRecord:
    """One finished (or failed) submission, posted to the run's bus."""

    unit: str
    chunk: Chunk
    elapsed: float               # execution time (dispatch -> result ready)
    dispatch_latency: float      # submit() -> execution actually starting
    error: Optional[BaseException] = None
    result: Any = None           # work_fn return value (serving uses this)


class CompletionBus:
    """The interrupt line of a run: backends post, the engine sleeps.

    Sharded hot path: each unit posts into its own deque slot (append is
    GIL-atomic, no shared lock) and raises a single shared
    :class:`threading.Event` — only the first post after a drain pays the
    notify, subsequent posts are a plain attribute check.  ``wait`` and
    ``drain`` belong to the single consumer (the dispatcher thread); the
    drain clears the event *before* sweeping the slots so a post racing
    the sweep re-arms it and can never be silently lost.  This is the
    wall-clock materialization of the paper's per-accelerator interrupt —
    except one bus serves all units, which is exactly what lets the
    dispatcher hand out the next chunk to *whichever* unit finished
    first.

    ``register(unit)`` pre-creates a unit's slot; posts from units that
    never registered land in a shared default slot, so the API is
    drop-in for the previous condition-variable bus.
    """

    def __init__(self) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()          # slot registry only, not posts
        self._default: deque = deque()
        self._slots: Dict[str, deque] = {}
        # copy-on-write scan tuple: producers may register new slots while
        # the consumer sweeps, so the sweep iterates an immutable snapshot
        self._scan: Tuple[deque, ...] = (self._default,)

    def register(self, unit: str) -> None:
        """Idempotently create a dedicated slot for ``unit``."""
        with self._lock:
            if unit not in self._slots:
                self._slots[unit] = deque()
                self._scan = tuple(self._slots.values()) + (self._default,)

    def post(self, rec: CompletionRecord) -> None:
        slot = self._slots.get(rec.unit)
        if slot is None:
            slot = self._default
        slot.append(rec)
        if not self._event.is_set():
            self._event.set()

    def _pending(self) -> bool:
        for slot in self._scan:
            if slot:
                return True
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Sleep until at least one completion is pending (or timeout)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            if self._pending():
                return True
            # Eat a stale set, then re-check: a producer appends *before*
            # setting, so anything posted before the clear is visible to
            # the re-check, and anything after it re-sets the event.
            self._event.clear()
            if self._pending():
                return True
            if deadline is None:
                self._event.wait()
            else:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._event.wait(remaining):
                    return self._pending()

    def drain(self) -> List[CompletionRecord]:
        self._event.clear()
        out: List[CompletionRecord] = []
        for slot in self._scan:
            while slot:
                try:
                    out.append(slot.popleft())
                except IndexError:  # pragma: no cover - single-consumer guard
                    break
        return out


class BackendUnit:
    """Protocol + shared bookkeeping for one asynchronously-driven unit.

    Lifecycle: ``start(bus)`` before the first submit (re-startable, so
    one instance can serve consecutive runs), ``submit(chunk, work_fn)``
    only while the unit has spare :attr:`capacity` (the engine polices
    this; plain units advertise ``capacity = 1``, i.e. one chunk in
    flight), ``close()`` at run end.  ``submit`` must not block on the
    work itself: completion is reported by posting a
    :class:`CompletionRecord` to the bus.

    Units that coalesce submissions (``capacity > 1``, e.g. a
    :class:`~repro.core.transport.RemoteUnit` with ``batch_frames > 1``)
    may buffer submits; the engine calls :meth:`flush` after each
    dispatch round to push out a partial batch.  For everything else
    ``flush`` is a no-op.
    """

    kind_name = "backend"
    #: max chunks the engine may keep in flight on this unit at once
    capacity = 1

    def __init__(self, name: str) -> None:
        self.name = name
        self._bus: Optional[CompletionBus] = None
        self.dispatch_latencies: List[float] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self, bus: CompletionBus) -> None:
        self._bus = bus
        bus.register(self.name)
        self.dispatch_latencies = []

    def submit(self, chunk: Chunk, work_fn: WorkFn) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Push out any buffered submissions (no-op for unbatched units)."""

    def close(self) -> None:
        self._bus = None

    # -- shared helpers -----------------------------------------------------
    def _post(self, rec: CompletionRecord) -> None:
        assert self._bus is not None, f"unit {self.name!r} not started"
        self.dispatch_latencies.append(rec.dispatch_latency)
        self._bus.post(rec)

    def _execute(self, chunk: Chunk, work_fn: WorkFn, submitted: float) -> None:
        """Run one chunk synchronously and post the completion."""
        t_start = time.perf_counter()
        result, error = None, None
        try:
            result = work_fn(chunk)
        except BaseException as exc:
            error = exc
        t_end = time.perf_counter()
        self._post(CompletionRecord(
            unit=self.name, chunk=chunk, elapsed=t_end - t_start,
            dispatch_latency=t_start - submitted, error=error, result=result,
        ))

    def describe(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class InlineUnit(BackendUnit):
    """Synchronous execution on the dispatcher thread.

    The degenerate backend: no overlap, but identical submit/complete
    bookkeeping — the control for dispatch-latency measurements and the
    deterministic option for engine unit tests.
    """

    kind_name = "inline"

    def submit(self, chunk: Chunk, work_fn: WorkFn) -> None:
        self._execute(chunk, work_fn, time.perf_counter())


class ThreadUnit(BackendUnit):
    """A dedicated worker thread per unit — the default real backend.

    ``submit`` enqueues and returns immediately; the worker executes and
    posts the completion.  Dispatch latency is queue wait: submit time to
    execution start.
    """

    kind_name = "thread"

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, bus: CompletionBus) -> None:
        super().start(bus)
        if self._thread is None or not self._thread.is_alive():
            self._queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._worker, name=f"eneac-unit-{self.name}", daemon=True
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            submitted, chunk, work_fn = item
            self._execute(chunk, work_fn, submitted)

    def submit(self, chunk: Chunk, work_fn: WorkFn) -> None:
        assert self._queue is not None, f"unit {self.name!r} not started"
        self._queue.put((time.perf_counter(), chunk, work_fn))

    def close(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=10.0)
        self._thread = None
        self._queue = None
        super().close()


def _process_entry(work_fn: WorkFn, chunk: Chunk, submitted: float):
    """Runs in the pool worker; perf_counter is CLOCK_MONOTONIC, which is
    system-wide on Linux, so the dispatch latency spans the process hop."""
    t_start = time.perf_counter()
    result = work_fn(chunk)
    t_end = time.perf_counter()
    return result, t_end - t_start, t_start - submitted


class ProcessPoolUnit(BackendUnit):
    """A single-worker process pool — multi-process CPU dispatch.

    Work functions (and their closures) must be picklable, and side
    effects land in the *worker* process: callers get results back via
    :attr:`CompletionRecord.result`, not shared memory.  If the host
    cannot spawn processes (a restricted CI host), the unit degrades to in-thread
    execution and sets :attr:`degraded`.
    """

    kind_name = "process"

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self._pool = None
        self.degraded = False
        self._fallback: Optional[ThreadUnit] = None

    def start(self, bus: CompletionBus) -> None:
        super().start(bus)
        if self._pool is None and not self.degraded:
            try:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor

                # spawn, not fork: the host process carries jax/XLA threads
                # and forking a multithreaded process can deadlock
                self._pool = ProcessPoolExecutor(
                    max_workers=1,
                    mp_context=multiprocessing.get_context("spawn"),
                )
                # force worker spawn now so a host that cannot spawn fails fast
                self._pool.submit(int, 0).result(timeout=60)
            except BaseException:
                self._pool = None
                self.degraded = True
        if self.degraded:
            if self._fallback is None:
                self._fallback = ThreadUnit(self.name)
            self._fallback.start(bus)
            self._fallback.dispatch_latencies = self.dispatch_latencies

    def submit(self, chunk: Chunk, work_fn: WorkFn) -> None:
        if self.degraded:
            assert self._fallback is not None
            self._fallback.submit(chunk, work_fn)
            return
        submitted = time.perf_counter()
        fut = self._pool.submit(_process_entry, work_fn, chunk, submitted)

        def on_done(f, *, chunk=chunk) -> None:
            error, result, elapsed, lat = None, None, 0.0, 0.0
            try:
                result, elapsed, lat = f.result()
            except BaseException as exc:
                error = exc
                elapsed = time.perf_counter() - submitted
            self._post(CompletionRecord(
                unit=self.name, chunk=chunk, elapsed=elapsed,
                dispatch_latency=lat, error=error, result=result,
            ))

        fut.add_done_callback(on_done)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None
        super().close()


class CudaStreamUnit(BackendUnit):
    """Dispatch onto a dedicated CUDA stream; an event is the interrupt.

    ``submit`` runs the work function on the dispatcher thread under the
    unit's own ``torch.cuda.Stream``: kernel launches are enqueued and the
    call returns without waiting for them.  The unit's stream first waits
    on the submitter's current stream, so the work sees every tensor the
    caller wrote before the submit.  A ``torch.cuda.Event`` recorded after
    the work goes to a waiter thread, whose ``event.synchronize()`` is the
    completion interrupt; the waiter then posts the
    :class:`CompletionRecord`.  The record holds what the work function
    returned, so those tensors stay alive until the stream has written
    them.

    ``device="cpu"`` runs each work function on the dedicated thread
    instead, which is how the tests drive the unit on a host without a
    card.  There is no silent fallback: a unit on a CUDA device raises at
    :meth:`start` when CUDA is not available.
    """

    kind_name = "cuda"

    def __init__(self, name: str, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(name)
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(
                f"CudaStreamUnit runs on a 'cuda' or 'cpu' device, got {device!r}"
            )
        self.stream: Optional[torch.cuda.Stream] = None
        self._waitq: Optional[queue.Queue] = None
        self._waiter: Optional[threading.Thread] = None

    def start(self, bus: CompletionBus) -> None:
        if self.device.type == "cuda" and self.stream is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"CudaStreamUnit {self.name!r} needs a CUDA device, but "
                    "torch.cuda.is_available() is False; pass device='cpu' "
                    "to run its work on a host thread instead"
                )
            self.stream = torch.cuda.Stream(device=self.device)
        super().start(bus)
        if self._waiter is None or not self._waiter.is_alive():
            self._waitq = queue.Queue()
            self._waiter = threading.Thread(
                target=self._wait_loop, name=f"eneac-cudawait-{self.name}",
                daemon=True,
            )
            self._waiter.start()

    def _wait_loop(self) -> None:
        while True:
            item = self._waitq.get()
            if item is None:
                return
            if self.stream is None:
                submitted, chunk, work_fn = item
                self._execute(chunk, work_fn, submitted)
                continue
            submitted, dispatched, chunk, out, error, event = item
            if error is None:
                try:
                    event.synchronize()
                except BaseException as exc:
                    error = exc
            t_end = time.perf_counter()
            self._post(CompletionRecord(
                unit=self.name, chunk=chunk, elapsed=t_end - dispatched,
                dispatch_latency=dispatched - submitted, error=error,
                result=out,
            ))

    def submit(self, chunk: Chunk, work_fn: WorkFn) -> None:
        assert self._waitq is not None, f"unit {self.name!r} not started"
        submitted = time.perf_counter()
        if self.stream is None:
            self._waitq.put((submitted, chunk, work_fn))
            return
        out, error, event = None, None, None
        try:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                out = work_fn(chunk)  # launches enqueued, not awaited
            event = torch.cuda.Event()
            event.record(self.stream)
        except BaseException as exc:
            error = exc
        self._waitq.put((submitted, time.perf_counter(), chunk, out, error, event))

    def close(self) -> None:
        if self._waiter is not None and self._waiter.is_alive():
            self._waitq.put(None)
            self._waiter.join(timeout=10.0)
        self._waiter = None
        self._waitq = None
        super().close()


def make_backend(spec: Union[str, BackendUnit, None], name: str) -> BackendUnit:
    """Normalize a backend spec (string / instance / None) to a unit.

    ``None`` means the runtime default — a :class:`ThreadUnit`, matching
    the paper's one-host-thread-per-unit design.
    """
    if isinstance(spec, BackendUnit):
        if spec.name != name:
            raise ValueError(
                f"backend unit is named {spec.name!r} but would back unit "
                f"{name!r}; names must match — completions are routed by "
                "unit name, and one backend instance can serve one unit only"
            )
        return spec
    if spec is None:
        return ThreadUnit(name)
    text = str(spec)
    if text.startswith("remote:"):
        address = text[len("remote:"):]
        opts: Dict[str, Any] = {}
        if "?" in address:
            address, _, query = address.partition("?")
            for part in query.split("&"):
                if not part:
                    continue
                key, _, value = part.partition("=")
                if key not in REMOTE_SPEC_KNOBS:
                    raise ValueError(
                        f"unknown remote backend knob {key!r} in {spec!r}: "
                        "valid knobs are " + ", ".join(REMOTE_SPEC_KNOBS)
                    )
                if key == "backend" or (key == "batch_frames" and value == "auto"):
                    opts[key] = value  # RemoteUnit validates the hosted backend
                    continue
                if key == "heartbeat":
                    # the one float-valued knob: an interval in seconds
                    try:
                        opts[key] = float(value)
                    except ValueError:
                        raise ValueError(
                            f"remote backend knob heartbeat={value!r} in "
                            f"{spec!r} must be a number of seconds"
                        ) from None
                    if not opts[key] > 0:
                        raise ValueError(
                            f"remote backend knob heartbeat={value!r} in "
                            f"{spec!r} must be positive"
                        )
                    continue
                try:
                    opts[key] = int(value)
                except ValueError:
                    raise ValueError(
                        f"remote backend knob {key}={value!r} in {spec!r} "
                        "must be an integer"
                        + (" or 'auto'" if key == "batch_frames" else "")
                    ) from None
        if not address:
            raise ValueError(
                "remote backend spec needs a worker address: "
                "'remote:<host:port>'"
            )
        from .transport import RemoteUnit  # late: transport builds on this module
        return RemoteUnit(
            name, address=address,
            remote_backend=opts.get("backend", "thread"),
            batch_frames=opts.get("batch_frames", 1),
            fn_cache=bool(opts.get("fn_cache", 1)),
            heartbeat=opts.get("heartbeat"),
            patience=int(opts.get("patience", 3)),
        )
    aliases = {
        "inline": InlineUnit,
        "thread": ThreadUnit, "threads": ThreadUnit,
        "process": ProcessPoolUnit, "processes": ProcessPoolUnit,
        "cuda": CudaStreamUnit,
    }
    cls = aliases.get(text)
    if cls is None:
        raise ValueError(
            f"unknown backend {spec!r}: valid specs are "
            + ", ".join(VALID_BACKEND_SPECS)
            + ", or a BackendUnit instance"
        )
    return cls(name)


# ---------------------------------------------------------------------------
# the event-driven wall-clock engine
# ---------------------------------------------------------------------------
class BackendEngine:
    """Completion-driven dispatcher over real backend units.

    The paper's Fig. 2 loop with the asynchrony made real: the dispatcher
    (caller thread) is the only client of the tracked scheduler — it
    hands each idle backend a chunk, sleeps on the :class:`CompletionBus`
    until any backend finishes (or the next elastic event is due), and
    applies membership changes between dispatches.  Because scheduler
    mutations are serialized on this thread *and* guarded by the tracked
    scheduler's internal lock, the exact-once coverage invariant holds
    even though executions genuinely overlap.

    ``elastic`` events use run-relative wall seconds.  Leave = retire
    (in-flight chunk completes and counts; pre-split leftovers are
    requeued); join = a fresh backend from ``join_backend`` starts
    stealing immediately.  Events due after full coverage are dropped.

    ``straggler`` attaches a
    :class:`~repro.core.straggler.StragglerDetector`: every successful
    completion feeds the unit's per-item service time, and a unit the
    detector convicts (EWMA over the fleet-median threshold for its
    configured consecutive patience) is *quarantined* — retired through
    the same path as an elastic leave, so the exact-once requeue
    invariant carries over unchanged.  At most one quarantine per unit
    per run; the last active unit is never quarantined (slow coverage
    beats no coverage).  Recorded as an ``action="straggler"`` event.
    """

    def __init__(
        self,
        sched,
        fns: Mapping[str, Optional[WorkFn]],
        units: Dict[str, BackendUnit],
        *,
        expected: int,
        elastic: Sequence[ElasticEvent] = (),
        default_fn: Optional[WorkFn] = None,
        join_backend: Optional[Callable[[ElasticEvent], BackendUnit]] = None,
        straggler=None,
    ) -> None:
        self.sched = sched
        self.fns: Dict[str, Optional[WorkFn]] = dict(fns)
        self.units = dict(units)
        self.expected = expected
        self.pending = sorted(elastic, key=lambda e: e.t)
        self.default_fn = default_fn
        self.join_backend = join_backend or (lambda ev: ThreadUnit(ev.unit))
        self.straggler = straggler
        self.bus = CompletionBus()
        self.events: List[dict] = []          # RunReport.events entries
        self._own_units = set()               # started here -> closed here
        self._all_units = dict(units)         # includes retired units (stats)
        self._inflight: Dict[str, int] = {}   # unit -> chunks in flight
        self._last_caps: Dict[str, int] = {}  # capacity last synced to sched
        self._leaving: set = set()
        self._straggled: set = set()
        self._errors: List[BaseException] = []
        self._t0 = 0.0

    # -- helpers ------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _any_busy(self) -> bool:
        return any(self._inflight.values())

    def _capacity(self, name: str) -> int:
        unit = self.units.get(name)
        return max(int(getattr(unit, "capacity", 1) or 1), 1)

    def _dispatch(self, name: str) -> bool:
        """Fill ``name`` up to its capacity, then flush its send buffer.

        A ``capacity == 1`` unit behaves exactly as before: one chunk in
        flight, the next issued only after its completion is processed.
        A pipelined unit (e.g. RemoteUnit with ``batch_frames > 1``) is
        handed up to ``capacity`` chunks back-to-back so it can coalesce
        them into one wire frame; scheduler-visible granularity and
        per-chunk completion accounting are unchanged.
        """
        if name in self._leaving or name in self.sched.removed:
            return False
        issued = False
        cap = self._capacity(name)
        # Adaptive units (batch_frames="auto") re-size their capacity at
        # flush boundaries; the scheduler's in-flight cap must follow or
        # next_chunk raises "requested a chunk while busy" the moment the
        # unit grows past the capacity recorded at run start.
        if cap != self._last_caps.get(name):
            self._last_caps[name] = cap
            set_cap = getattr(self.sched, "set_capacity", None)
            if set_cap is not None:
                set_cap(name, cap)
        while self._inflight.get(name, 0) < cap:
            if self._errors:
                break
            chunk = self.sched.next_chunk(name, now=time.perf_counter())
            if chunk is None:
                break
            self._inflight[name] = self._inflight.get(name, 0) + 1
            self.units[name].submit(chunk, self.fns[name])
            issued = True
        if issued:
            self.units[name].flush()
        return issued

    def _dispatch_idle(self) -> bool:
        any_issued = False
        for name in list(self.units):
            if self._dispatch(name):
                any_issued = True
        return any_issued

    def _retire(self, name: str) -> None:
        """Finalize a leave: remove from the scheduler (requeues pre-split
        leftovers under its lock) and close the unit's backend."""
        self.sched.remove_unit(name)
        self._leaving.discard(name)
        unit = self.units.pop(name, None)
        if unit is not None and name in self._own_units:
            unit.close()

    def _apply_due_events(self) -> None:
        while self.pending and self.pending[0].t <= self._now():
            ev = self.pending.pop(0)
            if self.sched.items_done() >= self.expected:
                continue  # run already covered; stale membership event
            if ev.action == "leave":
                self.events.append({
                    "t": self._now(), "action": "leave", "unit": ev.unit,
                    "requeued": None,
                })
                if self._inflight.get(ev.unit, 0):
                    # real work cannot be recalled: retire after completion
                    self._leaving.add(ev.unit)
                else:
                    self._retire(ev.unit)
            else:
                unit = self.join_backend(ev)
                unit.start(self.bus)
                self.units[ev.unit] = unit
                self._all_units[ev.unit] = unit
                self._own_units.add(ev.unit)
                self.fns[ev.unit] = self.default_fn
                self.sched.add_unit(ev.unit, ev.kind, throughput=ev.speed)
                set_cap = getattr(self.sched, "set_capacity", None)
                if set_cap is not None:
                    set_cap(ev.unit, self._capacity(ev.unit))
                self.events.append({
                    "t": self._now(), "action": "join", "unit": ev.unit,
                    "requeued": None,
                })
                self._dispatch(ev.unit)

    def _lose_unit(self, rec: CompletionRecord) -> None:
        """The medium (not the code) lost this unit: requeue, don't fail.

        A transport-backed unit posts a :class:`WorkerLost` completion when
        its connection drops or retransmits are exhausted.  The chunk was
        *not* completed — so instead of ``complete()`` the unit is removed
        from the tracked scheduler, which moves its in-flight chunk (and
        any never-issued pre-split assignment) to the requeue buffer under
        the scheduler's lock: survivors pick the span up exactly once.
        Recorded as an ``action="lost"`` entry in ``RunReport.events``.
        """
        name = rec.unit
        already_lost = name not in self.units and name in self.sched.removed
        self._inflight.pop(name, None)
        self._leaving.discard(name)
        if name not in self.sched.removed:
            self.sched.remove_unit(name)
        unit = self.units.pop(name, None)
        if unit is not None and name in self._own_units:
            unit.close()
        if already_lost:
            # a second WorkerLost for the same unit (e.g. a batched frame's
            # failure posted per pending chunk): membership already handled
            return
        self.events.append({
            # "dead" = missed-heartbeat conviction (silence); "lost" =
            # definitive EOF / retransmit exhaustion (loss mid-chunk)
            "t": self._now(),
            "action": "dead" if isinstance(rec.error, WorkerDead) else "lost",
            "unit": name,
            "requeued": (rec.chunk.start, rec.chunk.stop)
            if rec.chunk is not None else None,
        })

    def _process_completions(self, recs: List[CompletionRecord]) -> None:
        for rec in recs:
            if isinstance(rec.error, WorkerLost):
                self._lose_unit(rec)
                continue
            if rec.unit in self.sched.removed:
                # completion raced a loss/retire whose in-flight span was
                # already requeued; counting it now would double-cover
                continue
            n = self._inflight.get(rec.unit, 0)
            if n > 1:
                self._inflight[rec.unit] = n - 1
            else:
                self._inflight.pop(rec.unit, None)
            self.sched.complete(rec.unit, rec.elapsed, chunk=rec.chunk)
            if rec.error is not None:
                self._errors.append(rec.error)
            if rec.unit in self._leaving and not self._inflight.get(rec.unit, 0):
                self._retire(rec.unit)
            elif rec.error is None:
                self._observe_straggler(rec)

    def _observe_straggler(self, rec: CompletionRecord) -> None:
        """Feed one completion's per-item service time to the detector and
        quarantine the unit on conviction.

        Quarantine reuses the retire path: the scheduler requeues any
        never-issued pre-split assignment under its lock, so survivors
        pick the span up exactly once — the elastic invariant, unchanged.
        The completion that convicts has already been counted (real work
        is never recalled).  Never convicts the last active unit, and at
        most once per unit per run; ``forget`` drops the departed unit's
        EWMA so its stale sample stops skewing the fleet median.
        """
        det = self.straggler
        if det is None or rec.chunk is None or rec.chunk.size <= 0:
            return
        name = rec.unit
        if name in self._straggled or name in self.sched.removed:
            return
        report = det.observe({name: rec.elapsed / rec.chunk.size})
        if name not in report.stragglers:
            return
        active = [n for n in self.units
                  if n not in self.sched.removed and n not in self._leaving]
        if name not in active or len(active) <= 1:
            return
        self._straggled.add(name)
        self.events.append({
            "t": self._now(), "action": "straggler", "unit": name,
            "requeued": None, "ratio": report.ratios.get(name),
        })
        if self._inflight.get(name, 0):
            # pipelined unit with other chunks still executing: retiring now
            # would requeue work that is in flight remotely (double
            # execution).  Quarantine = stop feeding it; retire on drain.
            self._leaving.add(name)
        else:
            self._retire(name)
        det.forget(name)

    # -- the loop -----------------------------------------------------------
    def run(self) -> float:
        """Drive the space to completion; returns the wall makespan."""
        self._t0 = time.perf_counter()
        set_cap = getattr(self.sched, "set_capacity", None)
        for name, unit in self.units.items():
            unit.start(self.bus)
            self._own_units.add(name)
            self._last_caps[name] = self._capacity(name)
            if set_cap is not None:
                set_cap(name, self._last_caps[name])
        try:
            self._apply_due_events()
            self._dispatch_idle()
            while True:
                if self._any_busy():
                    timeout = None
                    if self.pending:
                        timeout = max(self.pending[0].t - self._now(), 0.0)
                    self.bus.wait(timeout=timeout)
                    self._apply_due_events()
                    self._process_completions(self.bus.drain())
                    self._dispatch_idle()
                    continue
                # nothing in flight: either more work is dispatchable, or
                # we are waiting for a membership event, or we are done
                self._apply_due_events()
                if self._dispatch_idle():
                    continue
                if self._any_busy():
                    continue
                if (self.pending and not self._errors
                        and self.sched.items_done() < self.expected):
                    # idle until the next event (e.g. a rescuing join)
                    time.sleep(max(self.pending[0].t - self._now(), 0.0))
                    self._apply_due_events()
                    continue
                break
        finally:
            for name, unit in self.units.items():
                if name in self._own_units:
                    unit.close()
        if self._errors:
            raise self._errors[0]
        return time.perf_counter() - self._t0

    def dispatch_latency(self) -> Dict[str, float]:
        """Mean submit->execution latency per unit, in seconds."""
        out: Dict[str, float] = {}
        for name, unit in self._all_units.items():
            lats = unit.dispatch_latencies
            if lats:
                out[name] = sum(lats) / len(lats)
        for name in self.sched.workers:
            out.setdefault(name, 0.0)
        return out

    def wire_latency(self) -> Optional[Dict[str, float]]:
        """Mean send->worker-accept seconds per transport unit.

        Only units that went over a transport carry ``wire_latencies``
        (see :class:`~repro.core.transport.RemoteUnit`); for everything
        else the wire component of dispatch latency is zero by
        construction, so units without samples are omitted and the whole
        map is ``None`` when no remote unit took part.
        """
        out: Dict[str, float] = {}
        for name, unit in self._all_units.items():
            lats = getattr(unit, "wire_latencies", None)
            if lats:
                out[name] = sum(lats) / len(lats)
        return out or None

    def frame_batching(self) -> Optional[Dict[str, int]]:
        """Effective frame-coalescing width per transport unit at run end.

        Fixed ``batch_frames=N`` units report N; ``batch_frames="auto"``
        units report the adaptive value they converged to.  ``None`` when
        no transport unit took part (local units have no frames to
        batch).
        """
        out: Dict[str, int] = {}
        for name, unit in self._all_units.items():
            width = getattr(unit, "effective_batch_frames", None)
            if width is not None:
                out[name] = int(width)
        return out or None

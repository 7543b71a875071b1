"""Continuous-batching serving engine driven by the ENEAC scheduler.

The port's copy of ``repro.serving.engine``.  The decode batch has B
*slots* (compute units); the request queue is the iteration space.  Two
refill policies:

* ``"static"`` — a batch of requests runs to the LAST finisher before any
  new request is admitted (the polling baseline).
* ``"continuous"`` — completion-driven: the moment a sequence finishes,
  its slot is refilled at the next step boundary.

Each decode slot registers as a compute unit of the port's
:class:`~repro_torch.core.runtime.HeteroRuntime`, and ``run()`` opens a
:class:`~repro_torch.core.runtime.WorkQueue` over a
:class:`~repro_torch.core.space.FlatSpace` of the queued requests, so
which request a freed slot picks up, and the per-slot coverage and
utilization accounting (:attr:`ServingEngine.last_run_report`), come from
the same scheduler as ``parallel_for``.  The snapshot is ordered by an
:class:`~repro_torch.serving.admission.AdmissionPolicy`, which also
decides backpressure in :meth:`ServingEngine.submit`.

Slot state lives in the batched caches; a new request is prefilled with
batch 1 and copied into its slot.  ``backend="threads"`` prefills on
per-slot :class:`~repro_torch.core.backends.ThreadUnit` threads while the
decode loop keeps stepping; ``backend="inline"`` (default) admits
synchronously.  ``backend="remote:<host:port>[,<host:port>...]"`` makes
each slot's prefill unit a :class:`~repro_torch.core.transport.RemoteUnit`,
round-robin over the addresses: admissions prefill in *worker processes*
(:func:`~repro_torch.core.transport.spawn_worker`), never in this one.
Remote mode needs ``model_spec={"config", "smoke", "seed", "device"}``
(``config`` a name or a ``ModelConfig``; ``device`` defaults to the
model's), from which each worker builds the model and its parameters once
with the seeded ``Model.init``, so they equal this process's when these
were built by ``Model.init(seed)`` on the same kind of device.  A ``cuda`` spec makes the workers host ``cuda``
units, so the prefill kernels run on the card in the worker.  The batch-1
cache comes back in the completion frame as CPU tensors (a pickled CUDA
tensor would reopen on the card inside this process's unpickler) and is
copied into its slot here.  A remote prefill that fails fails its request
(an error in its :class:`RequestResult`).

Requests carry tokens only, as the reference engine's do, so the engine
serves the token-only families (dense, moe, ssm, hybrid) and refuses
``encdec`` and ``vlm``, whose prefill also needs frames or image
embeddings: drive those through ``Model.prefill`` and ``decode_step``.

The reference jits prefill and decode; the port runs them eagerly.
Sampling is reproducible by construction: each sampled token draws from a
``torch.Generator`` seeded from (engine seed, request id, token index), so
a request's tokens do not depend on which other slots are occupied, which
slot it lands in, or the admission order.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.backends import BackendUnit, CompletionBus, ThreadUnit
from ..core.runtime import HeteroRuntime, WorkQueue
from ..core.scheduler import WorkerKind
from ..core.space import FlatSpace
from ..core.transport import RemoteUnit
from ..models.model_factory import Model, make_model, splice_slot
from .admission import AdmissionPolicy, AdmissionVerdict, make_policy
from .sampling import sample, token_generator

__all__ = ["Request", "RequestResult", "ServingEngine", "check_servable"]


# seconds a blocking wait for a threads- or remote-backend prefill may last
# before the engine reports the slot as stuck
PREFILL_TIMEOUT_S = 60.0


def prefill_first_token(model: Model, params, prompt, max_len: int, *, rid: int,
                        temperature: float, seed: int):
    """Batch-1 prefill of ``prompt`` and its first token: ``(cache, token)``.

    The first token honours ``temperature`` under the request's index-0
    generator ``token_seed(seed, rid, 0)``; decode steps continue the same
    stream.  Inline, threads and remote admission all draw it here.
    """
    device = torch.device(model.device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64, device=device)[None, :]
    logits, single = model.prefill(params, prompt, max_len)
    gens = [token_generator(seed, rid, 0, device)] if temperature > 0.0 else None
    return single, int(sample(logits, gens, temperature=temperature)[0])


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family whose prefill needs more than the
    tokens a :class:`Request` carries (``encdec``: frames; ``vlm``: image
    embeddings)."""
    source = {"encdec": "frames", "vlm": "image_embeds"}.get(cfg.family)
    if source is not None:
        raise ValueError(
            f"ServingEngine's requests carry tokens only, and the {cfg.family} family's "
            f"prefill also needs {source}=: drive {cfg.name} through Model.prefill and "
            "Model.decode_step")


# ---------------------------------------------------------------------------
# remote prefill: picklable work + a per-process model cache on the worker
# ---------------------------------------------------------------------------
_WORKER_MODELS: Dict[tuple, tuple] = {}
_WORKER_MODELS_LOCK = threading.Lock()


def _worker_model(spec: dict):
    """Build (model, params) once per worker process for a model spec.

    ``spec["config"]`` is a config name or a :class:`ModelConfig` (frozen,
    so it pickles and keys the cache).
    """
    key = (spec["config"], bool(spec.get("smoke", False)), int(spec.get("seed", 0)),
           str(spec.get("device", "cuda")))
    with _WORKER_MODELS_LOCK:
        if key not in _WORKER_MODELS:
            cfg = get_config(key[0]) if isinstance(key[0], str) else key[0]
            if key[1]:
                cfg = cfg.smoke()
            model = make_model(cfg, device=key[3])
            _WORKER_MODELS[key] = (model, model.init(key[2]))
        return _WORKER_MODELS[key]


class _RemotePrefill:
    """One request's prefill as picklable work for a remote worker.

    The worker builds the model from the spec (same config, seed and
    device kind => identical params), prefills batch 1, and returns the
    single-slot cache as CPU tensors, the first token (drawn by
    :func:`prefill_first_token`, so remote admission is token-identical
    to inline admission) and the seconds the prefill and the copy took.
    """

    def __init__(self, spec: dict, prompt, max_len: int, *,
                 rid: int, temperature: float, sample_seed: int) -> None:
        self.spec = dict(spec)
        self.prompt = np.asarray(prompt, np.int64)
        self.max_len = int(max_len)
        self.rid = int(rid)
        self.temperature = float(temperature)
        self.sample_seed = int(sample_seed)

    def __call__(self, chunk):
        model, params = _worker_model(self.spec)
        t0 = time.perf_counter()
        single, tok = prefill_first_token(
            model, params, self.prompt, self.max_len, rid=self.rid,
            temperature=self.temperature, seed=self.sample_seed)
        cpu = [dataclasses.replace(c, **{f.name: getattr(c, f.name).cpu()
                                         for f in dataclasses.fields(c)}) for c in single]
        return cpu, tok, time.perf_counter() - t0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int
    max_new_tokens: int
    eos_id: int = -1              # -1: run to max_new_tokens
    priority: int = 0             # PriorityPolicy: higher served first
    deadline: Optional[float] = None   # SLO budget, seconds from submit
    submitted_at: Optional[float] = None  # stamped by ServingEngine.submit


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    prompt_len: int
    submit_time: float
    finish_time: float
    first_token_time: Optional[float] = None   # prefill completion (TTFT)
    deadline: Optional[float] = None           # absolute; None = no SLO
    error: Optional[str] = None                # failed prefill etc.
    prefill_seconds: Optional[float] = None    # the prefill alone, on its unit

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (prefill completion), seconds."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def met_deadline(self) -> bool:
        """True iff the request finished successfully within its SLO
        (requests without a deadline always count)."""
        if self.error is not None:
            return False
        return self.deadline is None or self.finish_time <= self.deadline


class ServingEngine:
    def __init__(
        self,
        model: Model,
        params,
        *,
        slots: int = 4,
        max_len: int = 512,
        mode: str = "continuous",
        temperature: float = 0.0,
        seed: int = 0,
        backend: str = "inline",
        model_spec: Optional[dict] = None,
        policy: Union[str, AdmissionPolicy, None] = "fifo",
        max_queue: Optional[int] = None,
    ) -> None:
        if mode not in ("continuous", "static"):
            raise ValueError(mode)
        check_servable(model.cfg)
        is_remote = isinstance(backend, str) and backend.startswith("remote:")
        if backend not in ("inline", "threads") and not is_remote:
            raise ValueError(
                f"backend must be inline|threads|remote:<addr>[,...], got {backend!r}")
        if is_remote and not model_spec:
            raise ValueError(
                "backend='remote:...' needs model_spec={'config': name, 'smoke': bool, "
                "'seed': int, 'device': str} so workers can build the model")
        self.model = model
        self.params = params
        self.device = torch.device(model.device)
        self.slots = slots
        self.max_len = max_len
        self.mode = mode
        self.backend = backend
        self.model_spec = None
        if is_remote:
            self.model_spec = {"device": str(self.device), **model_spec}
        self.temperature = temperature
        self.seed = int(seed)
        self.policy = make_policy(policy, max_queue=max_queue)

        self.queue: Deque[Request] = deque()
        self._queue_lock = threading.Lock()  # submit() may race _run_loop
        self.results: Dict[int, RequestResult] = {}
        self.shed: Dict[int, AdmissionVerdict] = {}
        self._submit_times: Dict[int, float] = {}
        self._deadlines: Dict[int, float] = {}      # rid -> absolute deadline
        self._first_token: Dict[int, float] = {}    # rid -> TTFT timestamp
        self._prefill_seconds: Dict[int, float] = {}

        # decode slots are the compute units; run() opens a WorkQueue over
        # the submitted requests so refill is completion-driven (remote
        # prefill units are built by instance below, so the runtime registry
        # stays backend-less in remote mode)
        self.runtime = HeteroRuntime()
        for b in range(slots):
            self.runtime.register_unit(f"slot{b}", WorkerKind.ACC,
                                       backend=None if is_remote else self.backend)
        self._feed: Optional[WorkQueue] = None
        self._pending: List[Request] = []
        self._feed_exhausted = False
        # per-slot issuing feed: continuous mode retires an exhausted feed
        # while its chunks still decode, so completions must route to the
        # feed that issued them, not the current one
        self._slot_feed: List[Optional[WorkQueue]] = [None] * slots
        self._retired_feeds: List[WorkQueue] = []
        self.last_run_report = None

        # backend="threads": admitted requests prefill on a per-slot
        # ThreadUnit while the decode loop keeps stepping the active slots;
        # backend="remote:...": the same per-slot units, but RemoteUnits
        self._prefill_units: Optional[Dict[int, BackendUnit]] = None
        self._prefill_bus: Optional[CompletionBus] = None
        self._prefilling: Dict[int, Request] = {}
        if self.backend == "threads":
            self._prefill_bus = CompletionBus()
            self._prefill_units = {b: ThreadUnit(f"slot{b}") for b in range(slots)}
        elif is_remote:
            addrs = self.backend[len("remote:"):].split(",")
            hosted = "cuda" if torch.device(self.model_spec["device"]).type == "cuda" else "thread"
            self._prefill_bus = CompletionBus()
            self._prefill_units = {
                b: RemoteUnit(f"slot{b}", address=addrs[b % len(addrs)], remote_backend=hosted)
                for b in range(slots)
            }

        self.caches = model.init_caches(slots, max_len)
        self.active: List[Optional[Request]] = [None] * slots
        self.generated: List[List[int]] = [[] for _ in range(slots)]
        self.lengths = np.zeros(slots, np.int64)
        self.last_token = np.zeros(slots, np.int64)
        self.steps = 0
        self.decode_seconds = 0.0  # host clock over decode steps, sampling included

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> AdmissionVerdict:
        """Offer a request; returns the policy's admit/shed verdict.

        Shed requests are *not* queued (no result will appear for them);
        they are recorded in :attr:`shed` keyed by rid.  Safe to call from
        another thread than :meth:`run`.
        """
        now = time.perf_counter()
        with self._queue_lock:
            depth = len(self.queue)
        verdict = self.policy.admit(req, queue_depth=depth, now=now)
        if not verdict.admitted:
            self.shed[req.rid] = verdict
            return verdict
        req.submitted_at = now
        self._submit_times[req.rid] = now
        if req.deadline is not None:
            self._deadlines[req.rid] = now + req.deadline
        with self._queue_lock:
            self.queue.append(req)
        return verdict

    @property
    def has_work(self) -> bool:
        """True while anything is queued, prefilling, or decoding."""
        return (bool(self.queue) or bool(self._prefilling)
                or any(a is not None for a in self.active)
                or self._feed is not None)

    def _generator(self, rid: int, index: int) -> torch.Generator:
        return token_generator(self.seed, rid, index, self.device)

    def _prefill(self, req: Request):
        """Batch-1 prefill + first token, and the seconds the call took.

        Every backend reports the call's own time as the prefill's (a
        unit's ``elapsed`` depends on how it splits dispatch from work: a
        ``cuda`` unit counts its host enqueue as dispatch).
        """
        t0 = time.perf_counter()
        single, tok = prefill_first_token(self.model, self.params, req.prompt, self.max_len,
                                          rid=req.rid, temperature=self.temperature,
                                          seed=self.seed)  # the token waits for the card
        return single, tok, time.perf_counter() - t0

    def _install(self, slot: int, req: Request, single, tok: int,
                 prefill_elapsed: Optional[float] = None) -> None:
        """Copy a finished prefill into its decode slot (the thread running ``run``)."""
        splice_slot(self.caches, single, slot)
        self.active[slot] = req
        self.generated[slot] = [tok]
        self.lengths[slot] = len(req.prompt)
        self.last_token[slot] = tok
        self._first_token[req.rid] = time.perf_counter()
        if prefill_elapsed is not None:
            self._prefill_seconds[req.rid] = prefill_elapsed
            self.policy.observe_prefill(f"slot{slot}", len(req.prompt), prefill_elapsed)

    def _fail(self, slot: int, req: Request, error: BaseException) -> None:
        """Record a failed admission and close its scheduler chunk."""
        self.results[req.rid] = RequestResult(
            rid=req.rid,
            tokens=[],
            prompt_len=len(req.prompt),
            submit_time=self._submit_times[req.rid],
            finish_time=time.perf_counter(),
            deadline=self._deadlines.get(req.rid),
            error=f"{type(error).__name__}: {error}",
        )
        self._complete_chunk(slot)

    def _admit(self, slot: int) -> bool:
        if self._feed is None:
            return False
        chunk = self._feed.acquire(f"slot{slot}")
        if chunk is None:
            # every request of this snapshot has been issued; in continuous
            # mode the run loop may now retire the feed and re-snapshot
            self._feed_exhausted = True
            return False
        self._slot_feed[slot] = self._feed
        req = self._pending[chunk.start]
        if self._prefill_units is not None:
            # remote units need picklable work, so they get a _RemotePrefill
            # instead of a closure over the live model
            if self.model_spec is not None:
                work = _RemotePrefill(self.model_spec, req.prompt, self.max_len, rid=req.rid,
                                      temperature=self.temperature, sample_seed=self.seed)
            else:
                work = lambda c, req=req: self._prefill(req)  # noqa: E731
            self._prefilling[slot] = req
            self._prefill_units[slot].submit(chunk, work)
            return True
        try:
            single, tok, seconds = self._prefill(req)
        except Exception as exc:
            self._fail(slot, req, exc)
            return True
        self._install(slot, req, single, tok, prefill_elapsed=seconds)
        return True

    def _collect_prefills(self, block: bool = False) -> None:
        """Install any finished async prefills; optionally wait for one.

        A prefill that errored surfaces as a failed :class:`RequestResult`;
        a blocking wait that expires with prefills in flight raises, naming
        the stuck slots.
        """
        if self._prefill_bus is None or not self._prefilling:
            return
        if block:
            arrived = self._prefill_bus.wait(timeout=PREFILL_TIMEOUT_S)
            if not arrived and self._prefilling:
                stuck = ", ".join(f"slot{s}" for s in sorted(self._prefilling))
                raise TimeoutError(
                    f"no prefill completion within {PREFILL_TIMEOUT_S:.1f}s "
                    f"with prefills still in flight on {stuck}; the unit(s) "
                    "are stuck or dead"
                )
        for rec in self._prefill_bus.drain():
            slot = int(rec.unit[len("slot"):])
            req = self._prefilling.pop(slot)
            if rec.error is not None:
                self._fail(slot, req, rec.error)
                continue
            single, tok, seconds = rec.result
            self._install(slot, req, single, tok, prefill_elapsed=seconds)

    def _finish(self, slot: int) -> None:
        req = self.active[slot]
        assert req is not None
        self.results[req.rid] = RequestResult(
            rid=req.rid,
            tokens=list(self.generated[slot]),
            prompt_len=len(req.prompt),
            submit_time=self._submit_times[req.rid],
            finish_time=time.perf_counter(),
            first_token_time=self._first_token.get(req.rid),
            deadline=self._deadlines.get(req.rid),
            prefill_seconds=self._prefill_seconds.get(req.rid),
        )
        self.active[slot] = None
        self.generated[slot] = []
        self._complete_chunk(slot)

    def _slot_done(self, slot: int) -> bool:
        req = self.active[slot]
        if req is None:
            return False
        toks = self.generated[slot]
        if len(toks) >= req.max_new_tokens:
            return True
        return req.eos_id >= 0 and bool(toks) and toks[-1] == req.eos_id

    # ------------------------------------------------------------------
    def run(self) -> Dict[int, RequestResult]:
        """Serve until the queue drains and all slots finish."""
        started: List[BackendUnit] = []
        try:
            for unit in (self._prefill_units or {}).values():
                unit.start(self._prefill_bus)  # a refused remote unit raises here
                started.append(unit)
            return self._run_loop()
        finally:
            for unit in started:
                unit.close()

    def _snapshot_queue(self) -> None:
        """Open a policy-ordered feed over the currently queued requests."""
        with self._queue_lock:
            fresh = list(self.queue)
            self.queue.clear()
        if not fresh:
            return
        self._pending = self.policy.order(fresh, now=time.perf_counter())
        self._feed = self.runtime.work_queue(
            space=FlatSpace(len(self._pending)), policy="multidynamic", acc_chunk=1,
        )
        self._feed_exhausted = False

    def _retire_feed(self) -> None:
        """Stop acquiring from the current feed; report it when its last
        in-flight chunk completes (immediately if none are in flight)."""
        feed = self._feed
        self._feed = None
        if feed is None:
            return
        if any(f is feed for f in self._slot_feed):
            self._retired_feeds.append(feed)
        else:
            self.last_run_report = feed.report()
            self._attach_dispatch_stats(self.last_run_report)

    def _complete_chunk(self, slot: int) -> None:
        """Report the slot's chunk back to the feed that issued it."""
        feed = self._slot_feed[slot]
        self._slot_feed[slot] = None
        if feed is None:
            return
        feed.complete(f"slot{slot}")
        if (feed is not self._feed
                and any(f is feed for f in self._retired_feeds)
                and not any(f is feed for f in self._slot_feed)):
            self._retired_feeds = [f for f in self._retired_feeds if f is not feed]
            self.last_run_report = feed.report()
            self._attach_dispatch_stats(self.last_run_report)

    def _admit_pass(self) -> bool:
        """Offer every free slot work from the feed; True if any chunk was
        acquired.  A failed synchronous admission leaves its slot free with
        the chunk completed, so keep pulling until the slot is occupied or
        the feed has nothing left for it."""
        acquired = False
        for b in range(self.slots):
            while (self.active[b] is None
                   and b not in self._prefilling
                   and self._admit(b)):
                acquired = True
        return acquired

    def _run_loop(self) -> Dict[int, RequestResult]:
        while True:
            # a feed's iteration space is fixed at open time, so continuous
            # mode retires an exhausted feed as soon as new arrivals queue
            if (self.mode == "continuous" and self._feed is not None
                    and self._feed_exhausted and self.queue):
                self._retire_feed()
            if self._feed is None and self.queue:
                self._snapshot_queue()
            if self.mode == "continuous" or all(a is None for a in self.active):
                self._admit_pass()
            self._collect_prefills()
            if all(a is None for a in self.active):
                if self._prefilling:
                    self._collect_prefills(block=True)
                    continue
                if self._feed is not None and self._admit_pass():
                    continue
                self._retire_feed()
                if self.queue:  # submissions landed after the snapshot
                    continue
                return dict(self.results)

            t0 = time.perf_counter()
            tokens = torch.as_tensor(self.last_token, device=self.device)[:, None]
            positions = torch.as_tensor(
                self.lengths + np.array([len(g) for g in self.generated], np.int64) - 1,
                device=self.device)[:, None]
            logits, self.caches = self.model.decode_step(self.params, tokens, positions,
                                                         self.caches)
            nxt = self._sample_step(logits)  # reading the tokens waits for the card
            self.decode_seconds += time.perf_counter() - t0
            self.steps += 1
            for b in range(self.slots):
                if self.active[b] is None:
                    continue
                tok = int(nxt[b])
                self.generated[b].append(tok)
                self.last_token[b] = tok
                if self._slot_done(b):
                    self._finish(b)

    def _sample_step(self, logits: torch.Tensor) -> np.ndarray:
        """Sample one token per slot; stochastic draws use per-(rid, index)
        generators, so batch composition cannot perturb a request's tokens."""
        if self.temperature <= 0.0:
            return sample(logits, temperature=0.0).cpu().numpy()
        live = [b for b in range(self.slots) if self.active[b] is not None]
        gens = [self._generator(self.active[b].rid, len(self.generated[b])) for b in live]
        out = np.zeros(self.slots, np.int64)  # idle slots' tokens are never read
        out[live] = sample(logits[live], gens, temperature=self.temperature).cpu().numpy()
        return out

    def _attach_dispatch_stats(self, report) -> None:
        """Expose prefill dispatch latency per slot on the batch report, and
        for remote units its wire part (``RunReport.wire_latency``)."""
        if report is None or self._prefill_units is None:
            return
        stats, wire = {}, {}
        for b, unit in self._prefill_units.items():
            lats = unit.dispatch_latencies
            if lats:
                stats[f"slot{b}"] = sum(lats) / len(lats)
            lats = getattr(unit, "wire_latencies", None)
            if lats:
                wire[f"slot{b}"] = sum(lats) / len(lats)
        report.dispatch_latency = stats or None
        report.wire_latency = wire or None

    # ------------------------------------------------------------------
    def throughput_report(self) -> Dict[str, float]:
        """Serving metrics with a stable schema (zeros when nothing finished):

        ``tokens, steps, tokens_per_step, completed, failed, shed,
        mean_latency, p50_latency, p95_latency, p99_latency, mean_ttft,
        goodput_tokens``
        """
        done = [r for r in self.results.values() if r.error is None]
        failed = len(self.results) - len(done)
        total_tokens = sum(len(r.tokens) for r in done)
        lats = [r.latency for r in done]
        ttfts = [r.ttft for r in done if r.ttft is not None]

        def pct(p: float) -> float:
            return float(np.percentile(lats, p)) if lats else 0.0

        return {
            "tokens": total_tokens,
            "steps": self.steps,
            "tokens_per_step": total_tokens / max(self.steps, 1),
            "completed": len(done),
            "failed": failed,
            "shed": len(self.shed),
            "mean_latency": float(np.mean(lats)) if lats else 0.0,
            "p50_latency": pct(50.0),
            "p95_latency": pct(95.0),
            "p99_latency": pct(99.0),
            "mean_ttft": float(np.mean(ttfts)) if ttfts else 0.0,
            "goodput_tokens": sum(len(r.tokens) for r in done if r.met_deadline),
        }

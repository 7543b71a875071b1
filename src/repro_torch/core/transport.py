"""Multi-host transport backends: one runtime driving remote shard engines.

The port's copy of ``repro.core.transport``.  What differs: a worker hosts
``cuda`` units (:class:`~repro_torch.core.backends.CudaStreamUnit`) in place
of the reference's jax units, a worker that cannot start the unit a
``hello`` asks for (``cuda`` on a host without a card) answers with the
``error`` frame, and a remote spec may name the hosted backend
(``?backend=cuda``).  :func:`spawn_worker` starts this module's
:func:`_main`.  Two changes keep frames of tens of MB (a remote prefill's
cache) working: :class:`SocketTransport` waits with ``select`` rather than
socket timeouts, and a worker answers ``busy`` to a duplicate submit while
the completion it asks for is still in transit (``RemoteWorker._send_done``).

The ENEAC loop so far kept every compute unit in the dispatcher's address
space — threads, process pools, device streams.  This module stretches
the :class:`~repro_torch.core.backends.BackendUnit` boundary across a *message
transport*, the way HEROv2 (arXiv:2201.03861) stretches the host↔PULP
offload path across a real interconnect, while keeping dispatch latency
observable end-to-end (HTS, arXiv:1907.00271):

* **Frame codec** — length-prefixed pickled frames
  (:func:`encode_frame`, :class:`FrameDecoder`): a 4-byte big-endian
  payload length followed by the pickled frame dict.
* :class:`Transport` — the message boundary: ``send(frame)`` /
  ``recv(timeout)`` / ``close()``.  Two real implementations:
  :class:`LoopbackTransport` (an in-process queue pair that passes frames
  by reference — the deterministic test medium) and
  :class:`SocketTransport` (localhost/LAN TCP with the length-prefixed
  pickle codec).  :class:`FlakyTransport` wraps either with seeded
  drop / delay / duplicate / reorder fault injection — the first place in
  this repo where a completion can be lost by the *medium* instead of the
  code, which is why the reliability protocol below exists.
* :class:`RemoteWorker` — the far side: a serve loop that hosts real
  backend units (thread / inline / process / cuda) behind one transport
  session, executes submitted chunks on them, and pumps their
  completions back as frames.  :class:`WorkerServer` accepts TCP
  connections and runs one :class:`RemoteWorker` per connection;
  ``python -m repro_torch.core.transport`` serves one from a fresh process and
  :func:`spawn_worker` launches that as a managed subprocess.
* :class:`RemoteUnit` — the near side: a
  :class:`~repro_torch.core.backends.BackendUnit` proxy that makes a remote
  worker look like any other unit.  ``submit(chunk, work_fn)`` forwards a
  frame without blocking; a receiver thread pumps ``done`` frames back
  onto the run's :class:`~repro_torch.core.backends.CompletionBus`; dispatch
  latency is split into its local-queue and wire components
  (``RunReport.wire_latency``).

Reliability protocol (what makes the FlakyTransport battery pass):

* every submit carries a per-unit monotonically increasing ``seq``; the
  engine guarantees one chunk in flight per unit, so the proxy
  retransmits the pending frame on a timer until its completion arrives;
* the worker executes a seq **at most once**: duplicates of an already
  accepted seq re-send the cached ``done`` frame, or answer ``busy``
  while it is still executing — so dropped/duplicated/reordered frames
  never duplicate work-function side effects, and the retransmit budget
  measures worker *silence* rather than execution time (a chunk may
  legitimately run for minutes);
* the proxy ignores ``done`` frames whose seq is not the pending one, so
  duplicated completions are dropped on the floor;
* a definitive connection loss (EOF) or retransmit exhaustion posts a
  :class:`~repro_torch.core.backends.WorkerLost` completion, which
  :class:`~repro_torch.core.backends.BackendEngine` answers by removing the
  unit and requeueing its in-flight chunk to the survivors exactly once
  (an ``action="lost"`` event in ``RunReport.events``).

Failure semantics, stated honestly: when only *frames* are lost the
protocol preserves exact-once execution.  When the **worker itself** is
lost, a chunk it had already executed (whose completion never arrived)
is requeued and re-executed by a survivor — results stay correct because
the dead worker's results never surfaced, but external side effects need
an idempotent sink (e.g. write-per-index files, not appends).  This is
the standard at-least-once boundary of any distributed work queue; the
tests pin both halves of the contract.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import math
import os
import pickle
import queue
import random
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .backends import (
    BackendUnit,
    CompletionBus,
    CompletionRecord,
    WorkerDead,
    WorkerLost,
    make_backend,
)
from .scheduler import Chunk

logger = logging.getLogger(__name__)

__all__ = [
    "Transport",
    "TransportError",
    "TransportClosed",
    "LoopbackTransport",
    "SocketTransport",
    "FlakyTransport",
    "RemoteWorker",
    "WorkerServer",
    "RemoteUnit",
    "AUTO_BATCH_MAX",
    "SleepWork",
    "WorkerHandle",
    "spawn_worker",
    "encode_frame",
    "FrameDecoder",
    "MAX_FRAME_BYTES",
]


class TransportError(ConnectionError):
    """The transport failed to carry a frame (protocol or session error)."""


class TransportClosed(TransportError):
    """The transport is closed (locally or by the peer) — definitive EOF."""


# ---------------------------------------------------------------------------
# frame codec: length-prefixed pickled frames
# ---------------------------------------------------------------------------
_HEADER = struct.Struct(">I")
MAX_FRAME_BYTES = 256 * 1024 * 1024  # refuse absurd lengths (corrupt header)


def encode_frame(frame: dict) -> bytes:
    """``frame`` -> 4-byte big-endian payload length + pickled payload."""
    payload = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME_BYTES:
        raise TransportError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME_BYTES"
        )
    return _HEADER.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental decoder: feed byte chunks, get complete frames out.

    TCP delivers a byte stream, not messages; the decoder buffers partial
    frames across ``feed`` calls and yields each frame exactly once, in
    order, no matter how the stream was segmented.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def buffered(self) -> int:
        """Bytes held of a frame that is not whole yet."""
        return len(self._buf)

    def feed(self, data: bytes) -> List[dict]:
        self._buf += data
        out: List[dict] = []
        while True:
            if len(self._buf) < _HEADER.size:
                break
            (n,) = _HEADER.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                raise TransportError(
                    f"frame header claims {n} bytes (> {MAX_FRAME_BYTES}); "
                    "stream is corrupt"
                )
            if len(self._buf) < _HEADER.size + n:
                break
            payload = bytes(self._buf[_HEADER.size:_HEADER.size + n])
            del self._buf[:_HEADER.size + n]
            try:
                out.append(pickle.loads(payload))
            except Exception as exc:
                # The length prefix kept the stream aligned, so a payload
                # that cannot unpickle here (e.g. a work_fn whose module
                # the peer cannot import) is dropped as a poison frame —
                # the retransmit/WorkerLost protocol turns it into a
                # requeue instead of a dead session thread.
                out.append({"kind": "undecodable", "message": repr(exc)})
        return out


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------
class Transport:
    """Message boundary between a :class:`RemoteUnit` and its worker.

    ``send`` must be safe to call from multiple threads; ``recv`` is only
    ever called from one receiver thread.  ``recv`` returns ``None`` on
    timeout and raises :class:`TransportClosed` on definitive EOF.
    """

    def send(self, frame: dict) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError

    @property
    def partial_since(self) -> Optional[float]:
        """``perf_counter`` of the last bytes of a frame that has begun to
        arrive but is not whole yet; ``None`` when no frame is half-read
        (always, for a medium that delivers whole frames)."""
        return None


_EOF = object()


class LoopbackTransport(Transport):
    """In-process transport: a queue pair passing frames *by reference*.

    The deterministic test medium: no sockets, no pickling — which is
    deliberate, because by-reference delivery is what lets in-process
    tests share a side-effect ledger with the "remote" worker and assert
    exact-once semantics directly.  (Message-level fidelity — everything
    must survive pickling — is :class:`SocketTransport`'s job.)
    """

    def __init__(self) -> None:
        self._inbox: "queue.Queue" = queue.Queue()
        self._peer: Optional["LoopbackTransport"] = None
        self._closed = False

    @classmethod
    def pair(cls) -> Tuple["LoopbackTransport", "LoopbackTransport"]:
        a, b = cls(), cls()
        a._peer, b._peer = b, a
        return a, b

    def send(self, frame: dict) -> None:
        peer = self._peer
        if self._closed or peer is None or peer._closed:
            raise TransportClosed("loopback endpoint closed")
        peer._inbox.put(frame)

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        if self._closed:
            raise TransportClosed("loopback endpoint closed")
        try:
            item = self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is _EOF:
            self._inbox.put(_EOF)  # later recvs see EOF too
            raise TransportClosed("peer closed the loopback")
        return item

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._inbox.put(_EOF)
        if self._peer is not None:
            self._peer._inbox.put(_EOF)

    @property
    def closed(self) -> bool:
        return self._closed


def parse_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` (last colon splits the port)."""
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"address must be 'host:port', got {address!r}")
    return host, int(port)


class SocketTransport(Transport):
    """Length-prefixed pickled frames over a stream socket (TCP or UNIX).

    The socket carries no timeout; both directions wait with ``select``.
    A socket timeout would bound a whole ``sendall``, which a frame of tens
    of MB (a remote prefill's cache) outlasts while the peer drains it: the
    send would fail midway and leave the stream cut inside a frame.  A send
    instead fails only when the peer has taken no byte for
    ``send_timeout`` seconds (a peer that stopped reading), so a thread
    that sends never hangs on it.  A failed send or receive closes the
    socket, so the peer sees EOF.
    """

    def __init__(self, sock: socket.socket, *, send_timeout: float = 30.0) -> None:
        if not send_timeout > 0:
            raise ValueError(f"send_timeout must be positive, got {send_timeout!r}")
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # AF_UNIX / socketpair: no Nagle to disable
        sock.settimeout(None)  # no socket timeout: see the class docstring
        self._sock = sock
        self.send_timeout = float(send_timeout)
        self._decoder = FrameDecoder()
        self._ready: deque = deque()
        self._last_bytes = 0.0
        self._send_lock = threading.Lock()
        self._closed = False

    @classmethod
    def connect(cls, address: str, timeout: float = 10.0, *,
                send_timeout: float = 30.0) -> "SocketTransport":
        host, port = parse_address(address)
        return cls(socket.create_connection((host, port), timeout=timeout),
                   send_timeout=send_timeout)

    def send(self, frame: dict) -> None:
        data = memoryview(encode_frame(frame))  # pickling errors surface to the caller
        with self._send_lock:
            if self._closed:
                raise TransportClosed("socket transport closed")
            try:
                while data:
                    _, writable, _ = select.select([], [self._sock], [], self.send_timeout)
                    if not writable:
                        raise TimeoutError(
                            f"the peer took no byte for {self.send_timeout}s")
                    try:
                        data = data[self._sock.send(data, socket.MSG_DONTWAIT):]
                    except BlockingIOError:
                        continue  # the buffer filled again since select
            except (OSError, ValueError) as exc:  # ValueError: closed meanwhile
                self.close()
                raise TransportClosed(f"send failed: {exc}") from exc

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            if self._ready:
                return self._ready.popleft()
            if self._closed:
                raise TransportClosed("socket transport closed")
            remaining: Optional[float] = None
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
            try:
                readable, _, _ = select.select([self._sock], [], [], remaining)
                if not readable:
                    return None
                data = self._sock.recv(1 << 16)
            except (OSError, ValueError) as exc:  # ValueError: closed meanwhile
                self.close()
                raise TransportClosed(f"recv failed: {exc}") from exc
            if not data:
                self.close()
                raise TransportClosed("peer closed the connection")
            self._last_bytes = time.perf_counter()
            self._ready.extend(self._decoder.feed(data))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected, or already shut down
        self._sock.close()  # idempotent

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def partial_since(self) -> Optional[float]:
        return self._last_bytes if self._decoder.buffered else None


class FlakyTransport(Transport):
    """Seeded fault injection on the send path of any transport.

    Each sent frame independently draws from the seeded RNG: it may be
    **dropped** (never delivered), **duplicated** (delivered twice),
    **held for reordering** (delivered after the *next* frame), or
    **delayed** (delivered up to ``max_delay`` seconds late from a timer
    thread).  Receives pass straight through — wrap both endpoints to
    fault both directions.  Faults never raise: a frame racing a closing
    transport is just another drop, which the reliability protocol must
    absorb anyway.

    ``kinds`` restricts injection to frames of the named kinds (e.g.
    ``kinds=("heartbeat",)`` faults the liveness signal while work and
    completion frames ride a clean medium) — the lever the
    heartbeat-loss-vs-merely-slow battery needs to prove that a lossy
    heartbeat path alone never convicts a live worker.
    """

    def __init__(
        self,
        inner: Transport,
        *,
        seed: int,
        drop: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        delay: float = 0.0,
        max_delay: float = 0.02,
        kinds: Optional[Tuple[str, ...]] = None,
    ) -> None:
        self.inner = inner
        self.kinds = tuple(kinds) if kinds is not None else None
        self.drop = float(drop)
        self.duplicate = float(duplicate)
        self.reorder = float(reorder)
        self.delay = float(delay)
        self.max_delay = float(max_delay)
        self._rng = random.Random(seed)
        self._held: Optional[dict] = None
        self._lock = threading.Lock()
        self.stats = {"sent": 0, "dropped": 0, "duplicated": 0,
                      "reordered": 0, "delayed": 0}

    def _deliver(self, frame: dict) -> None:
        try:
            self.inner.send(frame)
        except TransportError:
            pass  # racing a close: equivalent to a drop

    def send(self, frame: dict) -> None:
        if self.kinds is not None and frame.get("kind") not in self.kinds:
            self._deliver(frame)  # out-of-scope kinds ride a clean medium
            return
        with self._lock:
            self.stats["sent"] += 1
            if self._rng.random() < self.drop:
                self.stats["dropped"] += 1
                return
            dup = self._rng.random() < self.duplicate
            hold = self._rng.random() < self.reorder
            delay_s = (
                self._rng.uniform(0.0, self.max_delay)
                if self._rng.random() < self.delay else 0.0
            )
            to_send: List[dict] = []
            if hold:
                self.stats["reordered"] += 1
                held, self._held = self._held, frame
                if held is not None:
                    to_send.append(held)  # an older frame jumps the queue
            else:
                to_send.append(frame)
                held, self._held = self._held, None
                if held is not None:
                    to_send.append(held)  # delivered after its successor
                if dup:
                    self.stats["duplicated"] += 1
                    to_send.append(frame)
        for f in to_send:
            if delay_s > 0.0:
                self.stats["delayed"] += 1
                timer = threading.Timer(delay_s, self._deliver, args=(f,))
                timer.daemon = True
                timer.start()
            else:
                self._deliver(f)

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        return self.inner.recv(timeout)

    def close(self) -> None:
        self.inner.close()  # a still-held frame dies with the session

    @property
    def closed(self) -> bool:
        return self.inner.closed

    @property
    def partial_since(self) -> Optional[float]:
        return self.inner.partial_since


# ---------------------------------------------------------------------------
# the far side: a worker hosting real backend units
# ---------------------------------------------------------------------------
_DONE_CACHE_DEPTH = 32  # completion items kept per unit for dup-resend
_HOSTABLE = ("thread", "threads", "inline", "process", "processes", "cuda")


class RemoteWorker:
    """Serve one transport session: host backend units, execute, report.

    Frames handled:

    * ``hello {unit, backend, heartbeat?}`` — start hosting a backend
      unit for ``unit`` (idempotent: duplicates re-ack with ``ready``);
      a bad backend spec, or a unit that fails to start (``cuda`` on a
      host without a card), answers with an ``error`` frame instead.  A
      positive ``heartbeat`` interval subscribes the client to periodic
      ``heartbeat {unit, queue_depth, inflight}`` frames — the ``busy``
      liveness answer generalized from "this seq is executing" to "this
      unit is alive", carrying the worker's accepted-but-uncompleted
      chunk count so the client can drive membership and autoscaling
      decisions from observed depth.  No request → no heartbeat frames
      (the legacy wire shape, exactly).
    * ``register_fn {unit, fn_id, fn}`` — the dispatch fast path's
      descriptor cache: store ``fn`` in the session registry so later
      work items can reference it by ``fn_id`` instead of re-shipping
      the pickled callable per chunk.  Idempotent; registry is
      per-session, so a worker restart naturally empties it.
    * ``submit {unit, seq, chunk, fn|fn_ref, t_submit, floor}`` — execute
      one chunk, **at most once per seq**: duplicates of an accepted seq
      re-send the cached ``done`` item, or answer ``busy`` while that seq
      is still executing (the client's liveness signal for long-running
      chunks), so retransmits and transport duplicates never duplicate
      side effects.  A ``fn_ref`` that is not in the registry (lost or
      never-sent registration, worker restart) answers ``unknown_fn`` —
      the client re-registers and retransmits.
    * ``work_batch {unit, floor, items: [{seq, chunk, fn|fn_ref,
      t_submit}, ...]}`` — several chunks in one frame (the client's
      ``batch_frames`` coalescing); each item is accepted/deduped
      independently under the same seq protocol, and ``floor`` (the
      client's lowest still-pending seq) prunes the accepted-seq set and
      the done cache.  With batching the client may have several frames
      racing, so acceptance is an exact per-seq set — a reordered older
      frame is still accepted after a newer one, and only seqs below
      ``floor`` (completions the client already processed) are dropped
      as stale.
    * ``bye {unit}`` — graceful drain: stop hosting the unit (its
      in-flight chunks complete first; thread/pool shutdown waits).
    * ``shutdown`` — end the serve loop.

    Completions drain through one pump pass per bus wakeup: all finished
    chunks of a unit found in one drain are posted as a single
    ``done_batch`` frame (a lone completion keeps the legacy ``done``
    shape), each item carrying ``t_accept`` (frame arrival) and
    ``t_start`` (execution start) so the client can attribute the wire
    transit per chunk without double counting.

    All timestamps are ``time.perf_counter()`` — CLOCK_MONOTONIC, which
    on Linux is shared by every process on one machine, so worker-side
    execution-start times compose with client-side submit times into one
    dispatch-latency measurement across *local* processes (same trick
    :class:`ProcessPoolUnit` uses).  Across machines the two clocks have
    unrelated epochs: execution/coverage semantics are unaffected, but
    the reported latency split is only meaningful when client and worker
    share a host (the supported benchmark/test topology).
    """

    def __init__(self, transport: Transport, *, poll_interval: float = 0.2) -> None:
        self.transport = transport
        self.poll_interval = poll_interval
        self.bus = CompletionBus()
        self._units: Dict[str, BackendUnit] = {}
        self._fns: Dict[str, Callable] = {}            # session fn registry
        self._accepted: Dict[str, set] = {}            # unit -> accepted seqs
        self._floor: Dict[str, int] = {}               # unit -> client floor
        # unit -> seq -> (t_accept, chunk), insertion-ordered
        self._inflight: Dict[str, "OrderedDict[int, Tuple[float, Chunk]]"] = {}
        self._done_cache: Dict[str, "OrderedDict[int, dict]"] = {}
        # unit -> seqs whose done is queued or being sent: a duplicate
        # submit of one is answered busy, not with another copy
        self._sending: Dict[str, set] = {}
        self._hb_interval: Dict[str, float] = {}   # unit -> requested secs
        self._hb_next: Dict[str, float] = {}       # unit -> next beat due
        self._beater: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()

    # -- outbound ------------------------------------------------------------
    @staticmethod
    def _strip(frame: dict, reason: Exception) -> dict:
        err = TransportError(f"completion payload not transportable: {reason}")
        if "items" in frame:
            return {**frame, "items": [
                {**item, "result": None, "error": err}
                for item in frame["items"]]}
        return {**frame, "result": None, "error": err}

    def _send(self, frame: dict) -> None:
        try:
            self.transport.send(frame)
            return
        except TransportClosed:
            self._stop.set()
            return
        except Exception as exc:
            # an untransportable payload (unpicklable result/error, or a
            # frame over MAX_FRAME_BYTES): strip it and keep the protocol
            # alive so the client gets an explanatory error instead of a
            # retransmit-exhaustion "lost worker"
            reason = exc
        try:
            self.transport.send(self._strip(frame, reason))
        except Exception as exc:
            # Not just TransportError: *any* failure here (a send-path bug,
            # an OSError the transport did not wrap) used to propagate into
            # the pump thread and kill it silently — the client would see a
            # stall and burn its whole retransmit budget.  The session is
            # unrecoverable either way, so end it deliberately: the client
            # gets a definitive EOF (WorkerLost → exact-once requeue)
            # instead of silence.
            logger.warning(
                "worker session send failed twice (%r after strip %r); "
                "ending session", exc, reason,
            )
            self._stop.set()

    # -- inbound -------------------------------------------------------------
    def _handle_hello(self, frame: dict) -> None:
        name = frame.get("unit")
        spec = frame.get("backend") or "thread"
        if name not in self._units:
            if not isinstance(spec, str) or spec not in _HOSTABLE:
                self._send({"kind": "error", "unit": name,
                            "message": f"worker cannot host backend {spec!r} "
                                       f"(want one of {_HOSTABLE})"})
                return
            try:
                unit = make_backend(spec, name)
                unit.start(self.bus)
            except Exception as exc:
                # never a fallback to another kind of unit: the client
                # asked for this backend and learns why it cannot have it
                self._send({"kind": "error", "unit": name,
                            "message": f"worker cannot start backend {spec!r}: "
                                       f"{type(exc).__name__}: {exc}"})
                return
            with self._lock:
                self._units[name] = unit
                self._accepted[name] = set()
                self._floor[name] = 0
                self._inflight[name] = OrderedDict()
                self._done_cache[name] = OrderedDict()
                self._sending[name] = set()
        hb = frame.get("heartbeat")
        if isinstance(hb, (int, float)) and hb > 0:
            start_beater = False
            with self._lock:
                self._hb_interval[name] = float(hb)
                self._hb_next[name] = 0.0  # first beat right after ready
                if self._beater is None or not self._beater.is_alive():
                    self._beater = threading.Thread(
                        target=self._beat_loop, daemon=True,
                        name="eneac-worker-beat",
                    )
                    start_beater = True
            if start_beater:
                self._beater.start()
        self._send({"kind": "ready", "unit": name})

    def _handle_register(self, frame: dict) -> None:
        fn_id, fn = frame.get("fn_id"), frame.get("fn")
        if fn_id is not None and fn is not None:
            with self._lock:
                self._fns[fn_id] = fn

    def _handle_work(self, frame: dict) -> None:
        """Accept the work items of a ``submit`` or ``work_batch`` frame."""
        name = frame.get("unit")
        items = frame.get("items") if frame.get("kind") == "work_batch" else [frame]
        t_accept = time.perf_counter()
        replies: List[dict] = []
        resend_items: List[dict] = []
        to_exec: List[Tuple[Chunk, Callable]] = []
        with self._lock:
            unit = self._units.get(name)
            if unit is None:
                return  # work raced ahead of hello; retransmit will return
            floor = frame.get("floor")
            if isinstance(floor, int) and floor > self._floor[name]:
                self._floor[name] = floor
                accepted = self._accepted[name]
                accepted -= {s for s in accepted if s < floor}
                cache = self._done_cache[name]
                for seq in [s for s in cache if s < floor]:
                    del cache[seq]
            for item in items or ():
                seq = item.get("seq")
                if seq is None or seq < self._floor[name]:
                    continue  # stale: the client already moved past it
                if seq in self._accepted[name]:
                    cached = self._done_cache[name].get(seq)
                    sending = self._sending[name]
                    if cached is not None and seq not in sending:
                        resend_items.append(cached)  # lost done: resend
                        sending.add(seq)
                    elif cached is not None or seq in self._inflight[name]:
                        # still executing, or its done still on the way:
                        # answer the probe so the client's retransmit
                        # budget measures *silence*, not work or transfer
                        replies.append({"kind": "busy", "unit": name,
                                        "seq": seq})
                    # else: completed and pruned — drop
                    continue
                if "fn" in item:
                    fn = item["fn"]
                else:
                    fn = self._fns.get(item.get("fn_ref"))
                    if fn is None:
                        # registration lost or pre-restart: NACK so the
                        # client re-registers and retransmits this seq
                        replies.append({"kind": "unknown_fn", "unit": name,
                                        "seq": seq,
                                        "fn_id": item.get("fn_ref")})
                        continue
                self._accepted[name].add(seq)
                self._inflight[name][seq] = (t_accept, item["chunk"])
                to_exec.append((item["chunk"], fn))
        if resend_items:
            self._send_done(name, resend_items)
        for reply in replies:
            self._send(reply)
        for chunk, fn in to_exec:
            unit.submit(chunk, fn)

    def _handle_bye(self, frame: dict) -> None:
        name = frame.get("unit")
        with self._lock:
            unit = self._units.pop(name, None)
            self._accepted.pop(name, None)
            self._floor.pop(name, None)
            self._inflight.pop(name, None)
            self._done_cache.pop(name, None)
            self._sending.pop(name, None)
            self._hb_interval.pop(name, None)
            self._hb_next.pop(name, None)
        if unit is not None:
            unit.close()  # waits for in-flight chunks (graceful drain)

    def _beat_loop(self) -> None:
        """Send each subscribed unit's periodic ``heartbeat`` frame.

        A dedicated timer thread (not the completion pump — the pump
        sleeps up to ``poll_interval`` per wakeup, which would starve
        intervals tighter than that).  ``queue_depth`` is the worker's
        accepted-but-uncompleted chunk count for the unit; ``inflight``
        is the slice of that depth the unit's backend can actually be
        executing right now (capped by its capacity).  Exits when the
        last subscription is dropped; a later ``hello`` restarts it.
        """
        while not self._stop.is_set():
            beats: List[dict] = []
            now = time.perf_counter()
            with self._lock:
                if not self._hb_interval:
                    return
                shortest = min(self._hb_interval.values())
                for name, interval in self._hb_interval.items():
                    if now < self._hb_next.get(name, 0.0):
                        continue
                    self._hb_next[name] = now + interval
                    depth = len(self._inflight.get(name, ()))
                    unit = self._units.get(name)
                    cap = max(int(getattr(unit, "capacity", 1) or 1), 1)
                    beats.append({"kind": "heartbeat", "unit": name,
                                  "queue_depth": depth,
                                  "inflight": min(depth, cap)})
            for beat in beats:
                self._send(beat)
            self._stop.wait(timeout=shortest / 2.0)

    def _pump(self) -> None:
        """Forward hosted-unit completions, one frame per unit per drain.

        Several completions of the same unit found in one drain coalesce
        into a single ``done_batch`` frame — the worker-side half of the
        frame-batching fast path; a lone completion keeps the legacy
        ``done`` frame shape.

        The loop body is exception-proof: every completion is inserted
        into the done cache *before* its frame is sent, so if anything
        here throws, the item is recoverable — the client's retransmit
        of the still-pending seq hits the dedup path and re-sends the
        cached ``done``.  An uncaught exception must therefore never
        kill this thread (the old behavior: a dead pump looked exactly
        like a stalled worker until the client burned its whole
        retransmit budget); it is logged and the pump keeps draining.
        """
        while not self._stop.is_set():
            try:
                self._pump_once()
            except Exception as exc:
                logger.warning(
                    "worker completion pump error (%r); completions remain "
                    "recoverable from the done cache via retransmit", exc,
                )

    def _pump_once(self) -> None:
        """One bus wait + drain + send pass (see :meth:`_pump`)."""
        self.bus.wait(timeout=self.poll_interval)
        grouped: "OrderedDict[str, List[dict]]" = OrderedDict()
        for rec in self.bus.drain():
            with self._lock:
                pend = self._inflight.get(rec.unit)
                entry = None
                if pend:
                    for seq, (t_accept, chunk) in pend.items():
                        if (chunk.start, chunk.stop) == (rec.chunk.start,
                                                         rec.chunk.stop):
                            entry = (seq, t_accept)
                            del pend[seq]
                            break
                if entry is None:
                    continue  # completion of a bye'd unit's last chunk
                seq, t_accept = entry
                item = {
                    "seq": seq, "chunk": rec.chunk,
                    "elapsed": rec.elapsed, "t_accept": t_accept,
                    "t_start": t_accept + rec.dispatch_latency,
                    "error": rec.error, "result": rec.result,
                }
                cache = self._done_cache.get(rec.unit)
                if cache is not None:
                    cache[seq] = item
                    self._sending[rec.unit].add(seq)
                    while len(cache) > _DONE_CACHE_DEPTH:
                        cache.popitem(last=False)
            grouped.setdefault(rec.unit, []).append(item)
        for name, items in grouped.items():
            self._send_done(name, items)

    def _send_done(self, name: str, items: List[dict]) -> None:
        """Send completion items (``done``, or ``done_batch`` for several).

        The callers mark these seqs as being sent before the call; until
        the send returns, a duplicate submit of one is answered ``busy``
        instead of with another copy.  A completion that carries a
        prefill's cache (tens of MB) takes tens of ms to go out, and every
        retransmit in that time would otherwise queue it again.  (The
        client sends no retransmit while a frame is still arriving, which
        covers the bytes that remain in flight after the send returns.)
        """
        if len(items) == 1:
            self._send({"kind": "done", "unit": name, **items[0]})
        else:
            self._send({"kind": "done_batch", "unit": name, "items": items})
        with self._lock:
            sending = self._sending.get(name)
            if sending is not None:
                sending.difference_update(item["seq"] for item in items)

    # -- the loop ------------------------------------------------------------
    def serve(self) -> None:
        """Blocking serve loop; returns when the session ends."""
        pump = threading.Thread(target=self._pump, daemon=True,
                                name="eneac-worker-pump")
        pump.start()
        try:
            while not self._stop.is_set():
                try:
                    frame = self.transport.recv(timeout=self.poll_interval)
                except TransportClosed:
                    break
                if frame is None:
                    continue
                kind = frame.get("kind")
                if kind == "hello":
                    self._handle_hello(frame)
                elif kind in ("submit", "work_batch"):
                    self._handle_work(frame)
                elif kind == "register_fn":
                    self._handle_register(frame)
                elif kind == "bye":
                    self._handle_bye(frame)
                elif kind == "shutdown":
                    break
                # unknown kinds are ignored (forward compatibility)
        finally:
            self._stop.set()
            pump.join(timeout=10.0)
            beater = self._beater
            if beater is not None:
                beater.join(timeout=5.0)
            with self._lock:
                units, self._units = dict(self._units), {}
            for name, unit in units.items():
                try:
                    unit.close()
                except Exception as exc:
                    # shutdown is best-effort, but a failed close is a
                    # leaked backend (threads, subprocesses) — say so
                    logger.warning(
                        "failed to close hosted unit %r at session end: %r",
                        name, exc,
                    )
            self.transport.close()

    def stop(self) -> None:
        self._stop.set()


class WorkerServer:
    """TCP front door: one :class:`RemoteWorker` session per connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.address = f"{self.host}:{self.port}"
        self._stop = threading.Event()
        self._workers: List[RemoteWorker] = []
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None

    def serve_forever(self) -> None:
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            worker = RemoteWorker(SocketTransport(conn))
            t = threading.Thread(target=worker.serve, daemon=True,
                                 name=f"eneac-worker-conn{len(self._threads)}")
            t.start()
            self._workers.append(worker)
            self._threads.append(t)

    def start(self) -> "WorkerServer":
        """Serve from a daemon thread (in-process test servers)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="eneac-worker-accept"
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for worker in self._workers:
            worker.stop()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# the near side: the proxy unit
# ---------------------------------------------------------------------------
# Adaptive frame-batching bounds: "auto" never shrinks the wire shape
# below the legacy one-chunk frame and never coalesces more chunks than
# this into a single frame (a lost frame costs one retransmit of
# everything on it, so unbounded batches would magnify fault recovery).
AUTO_BATCH_MAX = 32
_AUTO_BATCH_ALPHA = 0.4


class RemoteUnit(BackendUnit):
    """A :class:`BackendUnit` whose execution happens behind a transport.

    Construct with either ``address="host:port"`` (connects a
    :class:`SocketTransport` at ``start``; reconnects on restart) or an
    already-connected ``transport=`` endpoint (loopback tests; single
    session).  ``remote_backend`` names the backend the worker hosts for
    this unit ("thread" by default).

    Dispatch fast path knobs:

    * ``fn_cache`` (default on) — the session descriptor cache: each
      distinct work function is shipped **once** via a ``register_fn``
      frame and referenced by a content-hash id in every work item
      after that, instead of re-pickling the whole callable per chunk.
      A changed function hashes differently and re-registers; an
      unpicklable one (loopback lambdas) falls back to an identity-based
      id, still by-reference-safe.  If the worker does not know the id
      (dropped registration, worker restart → new session), it answers
      ``unknown_fn`` and the client re-registers and retransmits — the
      seq/dedup exact-once invariant is preserved because the work item
      itself was never accepted.
    * ``batch_frames`` (default 1) — coalesce up to this many queued
      chunks into one ``work_batch`` frame, amortizing the per-frame
      wire cost.  The unit advertises ``capacity = batch_frames`` so the
      engine pipelines that many chunks; scheduler-visible granularity
      and per-chunk completion accounting are unchanged, and
      ``batch_frames=1`` keeps the legacy one-``submit``-per-chunk wire
      shape exactly.  ``batch_frames="auto"`` sizes the width adaptively
      from what the unit learns on the wire: an EWMA of raw frame
      transit time (send → worker accept, the cost one frame pays
      regardless of how many chunks ride it) against an EWMA of
      per-chunk service time, so a high-latency link grows the batch
      until the wire cost is amortized below one chunk's work.  The
      width starts at 1 (legacy shape), is re-evaluated at every flush
      boundary, and is clamped to ``[1, AUTO_BATCH_MAX]``; the converged
      value is surfaced per unit as ``RunReport.batch_frames``.

    ``submit`` is non-blocking: it buffers the chunk (sending
    immediately when a batch fills or :meth:`flush` is called); the
    receiver thread retransmits all still-pending work every
    ``retry_interval`` seconds until each ``done`` arrives (the worker
    dedups by exact seq set, so retransmits are safe), posts completions
    to the run's bus, and records the dispatch-latency split —

    * ``dispatch_latencies``: submit → remote execution start (total),
    * ``local_queue_latencies``: submit → first socket write,
    * ``wire_latencies``: first write → the worker's accept of the frame,
      attributed **per chunk** (divided by the number of chunks that
      shared the frame) so a batched frame's wire time is never
      double-counted; surfaced as ``RunReport.wire_latency``.  (The
      reference also counts the wait on the worker before execution
      starts; that wait stays in ``dispatch_latencies`` here.)

    The split subtracts worker-side from client-side ``perf_counter``
    readings, so it is meaningful when both share a machine (subprocess
    workers — the supported topology); a cross-machine worker skews the
    latency numbers by the clock-epoch offset without affecting
    execution or coverage semantics.

    Definitive EOF, a failed send, or ``max_retries`` unanswered
    retransmits post a :class:`~repro_torch.core.backends.WorkerLost`
    completion instead — the engine's signal to requeue the in-flight
    chunks and drop this unit from the run.

    Heartbeat liveness (fleet membership): ``heartbeat=SECS`` subscribes
    to periodic worker ``heartbeat`` frames (requested via the ``hello``
    handshake) and arms missed-heartbeat conviction — if *nothing* is
    heard from the worker (heartbeats, completions, busy answers; any
    frame proves the process is alive) for ``patience`` consecutive
    intervals, the unit posts a
    :class:`~repro_torch.core.backends.WorkerDead` completion: the engine
    retires it through the elastic path (``action="dead"``) without
    waiting for a retransmit budget to burn down mid-chunk — and, unlike
    the retransmit path, an *idle* unit's death is detected too, which
    is what lets a :class:`~repro_torch.core.fleet.FleetManager` convict
    members between runs.  Conviction is patience-gated exactly like
    :class:`~repro_torch.core.straggler.StragglerDetector`: one late beat is
    not a verdict, only sustained silence is.  The most recent heartbeat
    payload is kept in :attr:`last_heartbeat` (``queue_depth`` /
    ``inflight``) for membership and autoscaling observers.
    """

    kind_name = "remote"

    def __init__(
        self,
        name: str,
        address: Optional[str] = None,
        *,
        transport: Optional[Transport] = None,
        remote_backend: str = "thread",
        retry_interval: float = 0.1,
        max_retries: int = 100,
        connect_timeout: float = 10.0,
        batch_frames: Union[int, str] = 1,
        fn_cache: bool = True,
        heartbeat: Optional[float] = None,
        patience: int = 3,
    ) -> None:
        super().__init__(name)
        if (address is None) == (transport is None):
            raise ValueError("pass exactly one of address= or transport=")
        if remote_backend not in _HOSTABLE:
            raise ValueError(
                f"remote_backend must be one of {_HOSTABLE}, "
                f"got {remote_backend!r} (no proxy chains)"
            )
        if heartbeat is not None and not float(heartbeat) > 0:
            raise ValueError(f"heartbeat must be positive, got {heartbeat!r}")
        if int(patience) < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.auto_batch = batch_frames == "auto"
        if self.auto_batch:
            self._batch = 1  # legacy wire shape until the link is measured
        else:
            if isinstance(batch_frames, str):
                raise ValueError(
                    f"batch_frames must be an int >= 1 or 'auto', "
                    f"got {batch_frames!r}"
                )
            if int(batch_frames) < 1:
                raise ValueError(f"batch_frames must be >= 1, got {batch_frames}")
            self._batch = int(batch_frames)
        self.address = address
        self.remote_backend = remote_backend
        self.retry_interval = float(retry_interval)
        self.max_retries = int(max_retries)
        self.connect_timeout = float(connect_timeout)
        self.fn_cache = bool(fn_cache)
        self.heartbeat = None if heartbeat is None else float(heartbeat)
        self.patience = int(patience)
        self.last_heartbeat: Optional[dict] = None  # latest beat payload
        self._last_heard = 0.0       # perf_counter of the last frame heard
        self._closed = False
        # Adaptive-width state: raw frame transit vs. per-chunk service
        # EWMAs (seconds); kept across restarts — the link does not
        # forget its character when a session reconnects.
        self._ewma_transit: Optional[float] = None
        self._ewma_service: Optional[float] = None
        self._transport = transport
        self.lost = False
        self.wire_latencies: List[float] = []
        self.local_queue_latencies: List[float] = []
        self._seq = 0
        # seq -> {seq, chunk, fn, t_submit, t_sent, sends, next_resend,
        #         batch_n}; insertion order == seq order
        self._pending: "OrderedDict[int, dict]" = OrderedDict()
        self._unsent: List[int] = []
        self._registered: set = set()               # fn_ids the worker knows
        self._fn_refs: Dict[str, Callable] = {}     # keep ids alive
        self._fn_id_cache: Dict[int, str] = {}      # id(fn) -> fn_id
        self._plock = threading.Lock()
        self._stop = threading.Event()
        self._recv_thread: Optional[threading.Thread] = None

    # -- adaptive frame batching --------------------------------------------
    @property
    def batch_frames(self) -> int:
        """Current frame-coalescing width (fixed value, or the adaptive
        one when constructed with ``batch_frames="auto"``)."""
        return self._batch

    @property
    def capacity(self) -> int:
        # the engine pipelines exactly one frame's worth of chunks
        return self._batch

    @property
    def effective_batch_frames(self) -> int:
        """Alias surfaced into ``RunReport.batch_frames`` by the engine."""
        return self._batch

    def _auto_resize(self) -> None:
        """Re-size the adaptive width from the learned link character.

        Target: enough chunks per frame that the raw frame transit time
        (paid once per frame, whatever rides on it) is amortized below
        one chunk's service time — ``ceil(transit / service)``, clamped
        to ``[1, AUTO_BATCH_MAX]``.  Called at flush boundaries so the
        width only moves between frames, never inside one.
        """
        if not self.auto_batch:
            return
        with self._plock:
            transit, service = self._ewma_transit, self._ewma_service
        if transit is None or service is None:
            return
        target = math.ceil(transit / max(service, 1e-9))
        self._batch = max(1, min(int(target), AUTO_BATCH_MAX))

    # -- lifecycle ----------------------------------------------------------
    def start(self, bus: CompletionBus) -> None:
        super().start(bus)
        self.wire_latencies = []
        self.local_queue_latencies = []
        with self._plock:
            # fresh session: the worker's fn registry is per-session, so
            # every descriptor must be re-shipped after a restart
            self._pending = OrderedDict()
            self._unsent = []
            self._registered = set()
            self._fn_refs = {}
            self._fn_id_cache = {}
        if self._transport is None or self._transport.closed:
            if self.address is None:
                raise TransportClosed(
                    f"unit {self.name!r}: injected transport is closed and "
                    "there is no address to reconnect to"
                )
            # a send to a worker that stopped reading fails as soon as
            # the worker would be convicted silent
            self._transport = SocketTransport.connect(
                self.address, timeout=self.connect_timeout,
                send_timeout=(self.connect_timeout if self.heartbeat is None
                              else self.patience * self.heartbeat),
            )
        self.lost = False
        self._closed = False
        self._stop.clear()
        self._handshake()
        self._last_heard = time.perf_counter()  # ready answered: alive now
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"eneac-remote-{self.name}",
        )
        self._recv_thread.start()

    def _handshake(self) -> None:
        """hello → ready, retransmitting until the worker answers."""
        hello = {"kind": "hello", "unit": self.name,
                 "backend": self.remote_backend}
        if self.heartbeat is not None:
            hello["heartbeat"] = self.heartbeat
        deadline = time.perf_counter() + self.connect_timeout
        next_hello = 0.0
        while time.perf_counter() < deadline:
            if time.perf_counter() >= next_hello:
                self._transport.send(hello)
                next_hello = time.perf_counter() + max(self.retry_interval, 0.02)
            frame = self._transport.recv(timeout=0.02)
            if frame is None:
                continue
            kind = frame.get("kind")
            if kind == "ready" and frame.get("unit") == self.name:
                return
            if kind == "error" and frame.get("unit") == self.name:
                raise TransportError(
                    f"worker refused unit {self.name!r}: {frame.get('message')}"
                )
            # stale frames from an earlier session are ignored
        raise TransportError(
            f"worker for unit {self.name!r} did not answer hello within "
            f"{self.connect_timeout}s"
        )

    def close(self) -> None:
        if self._closed:
            return  # idempotent: a second close must not re-send bye
        self._closed = True
        self._stop.set()
        if self._transport is not None and not self._transport.closed:
            try:
                self._transport.send({"kind": "bye", "unit": self.name})
            except TransportError as exc:
                # A swallowed failure here used to leave the worker
                # hosting a retired unit forever (it never saw the bye
                # and the session stayed open).  The close still
                # proceeds — the transport.close() below gives the
                # worker a definitive EOF — but the failed drain is
                # surfaced instead of silently dropped.
                logger.warning(
                    "unit %r: graceful bye failed (%r); closing the "
                    "transport so the worker sees EOF instead",
                    self.name, exc,
                )
        thread = self._recv_thread
        if (thread is not None and thread.is_alive()
                and thread is not threading.current_thread()):
            thread.join(timeout=5.0)  # bounded: never hangs the caller
        self._recv_thread = None
        if self._transport is not None:
            self._transport.close()
        super().close()

    # -- descriptor cache ---------------------------------------------------
    def _fn_id(self, fn: Callable) -> str:
        """Content-hash id for ``fn`` (identity-cached per object).

        ``h:<sha1>`` of the pickled callable — two objects with the same
        content share a registration, and a *changed* function hashes
        differently so it re-registers.  Unpicklable callables (loopback
        lambdas, closures over live objects) get an identity id
        ``r:<id>``; the strong reference kept in ``_fn_refs`` makes the
        id stable for the session.
        """
        key = id(fn)
        cached = self._fn_id_cache.get(key)
        if cached is not None and self._fn_refs.get(cached) is fn:
            return cached
        try:
            blob = pickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL)
            fid = "h:" + hashlib.sha1(blob).hexdigest()[:16]
        except Exception:
            fid = f"r:{id(fn):x}"
        self._fn_id_cache[key] = fid
        self._fn_refs[fid] = fn
        return fid

    # -- submission ---------------------------------------------------------
    def submit(self, chunk: Chunk, work_fn: Callable[[Chunk], Any]) -> None:
        if self.lost or self._transport is None or self._transport.closed:
            self._post_lost(chunk, "transport already lost at submit")
            return
        t_submit = time.perf_counter()
        with self._plock:
            seq = self._seq
            self._seq += 1
            self._pending[seq] = {
                "seq": seq, "chunk": chunk, "fn": work_fn,
                "t_submit": t_submit, "t_sent": None, "sends": 0,
                "next_resend": 0.0, "batch_n": 1,
            }
            self._unsent.append(seq)
            full = len(self._unsent) >= self.batch_frames
        if full:
            self.flush()

    def flush(self) -> None:
        """Send every buffered (not-yet-transmitted) chunk now.

        A flush is also the adaptive-width re-evaluation boundary: the
        buffered frame goes out at the width it was filled for, then the
        width adjusts for the next fill.
        """
        self._transmit(resend=False)
        self._auto_resize()

    def _transmit(self, *, resend: bool) -> None:
        """Frame and send pending work: the unsent buffer (``resend=False``)
        or everything already on the wire (``resend=True``, one batch).

        A single item keeps the legacy ``submit`` frame shape; two or
        more coalesce into one ``work_batch``.  Needed ``register_fn``
        frames precede the work frame.  ``floor`` — the lowest seq the
        client still cares about — rides on every work frame so the
        worker can prune its accepted-seq set and done cache.
        """
        frames: List[dict] = []
        with self._plock:
            if resend:
                seqs = [s for s, p in self._pending.items()
                        if p["t_sent"] is not None]
            else:
                seqs, self._unsent = self._unsent, []
            if not seqs:
                return
            now = time.perf_counter()
            floor = min(self._pending) if self._pending else self._seq
            items: List[dict] = []
            for seq in seqs:
                p = self._pending.get(seq)
                if p is None:
                    continue  # completed while queued for resend
                if p["t_sent"] is None:
                    p["t_sent"] = now
                p["sends"] += 1
                p["next_resend"] = now + self.retry_interval
                item = {"seq": seq, "chunk": p["chunk"],
                        "t_submit": p["t_submit"]}
                if self.fn_cache:
                    fid = self._fn_id(p["fn"])
                    if fid not in self._registered:
                        frames.append({"kind": "register_fn",
                                       "unit": self.name,
                                       "fn_id": fid, "fn": p["fn"]})
                        self._registered.add(fid)
                    item["fn_ref"] = fid
                else:
                    item["fn"] = p["fn"]
                items.append(item)
            if not items:
                return
            if not resend:
                # first transmission: record how many chunks share the
                # frame, for the per-chunk wire-time attribution
                for item in items:
                    p = self._pending.get(item["seq"])
                    if p is not None:
                        p["batch_n"] = len(items)
            if len(items) == 1:
                frames.append({"kind": "submit", "unit": self.name,
                               "floor": floor, **items[0]})
            else:
                frames.append({"kind": "work_batch", "unit": self.name,
                               "floor": floor, "items": items})
        try:
            for frame in frames:
                self._transport.send(frame)
        except TransportError:
            if not self._convict_if_silent():  # a send that stalled on a dead worker
                self._fail_pending("connection lost while sending work")

    # -- the receiver thread -------------------------------------------------
    def _recv_loop(self) -> None:
        tick = max(min(self.retry_interval / 2.0, 0.05), 0.005)
        if self.heartbeat is not None:
            # convictions must be checked a few times per interval or a
            # coarse tick adds a whole tick of detection latency
            tick = min(tick, self.heartbeat / 4.0)
        while not self._stop.is_set():
            try:
                frame = self._transport.recv(timeout=tick)
            except TransportClosed:
                self._fail_pending("connection closed by the worker")
                return
            if frame is not None:
                # any frame from the session proves the worker process is
                # alive, whatever unit or seq it concerns
                self._last_heard = time.perf_counter()
                self._on_frame(frame)
            partial = self._transport.partial_since
            if partial is not None:
                # part of a frame arrived: the worker is alive, and while
                # bytes keep coming a retransmit would only fetch another
                # copy of a completion that is on its way
                self._last_heard = max(self._last_heard, partial)
            if self._convict_if_silent():
                return
            if partial is None or time.perf_counter() - partial > self.retry_interval:
                self._maybe_retransmit()

    def _convict_if_silent(self) -> bool:
        """Missed-heartbeat conviction (heartbeat-enabled units only).

        Patience-gated like the straggler detector: the worker is
        convicted as *dead* only after ``patience`` full intervals with
        no frame of any kind — one dropped or late beat is absorbed.
        Unlike retransmit exhaustion this fires for an idle unit too,
        so a dead worker is discovered without submitting work to it.
        """
        if self.heartbeat is None or self.lost:
            return False
        silent_for = time.perf_counter() - self._last_heard
        if silent_for <= self.patience * self.heartbeat:
            return False
        self._fail_pending(
            f"no heartbeat for {silent_for:.3f}s "
            f"(> patience {self.patience} x {self.heartbeat}s)",
            error_cls=WorkerDead,
        )
        return True

    def _maybe_retransmit(self) -> None:
        exhausted = False
        resend = False
        flush_stranded = False
        now = time.perf_counter()
        with self._plock:
            for p in self._pending.values():
                if p["t_sent"] is None:
                    # safety net: an unsent chunk nobody flushed (a driver
                    # bypassing the engine's flush) still goes out
                    if now >= p["t_submit"] + self.retry_interval:
                        flush_stranded = True
                    continue
                if now >= p["next_resend"]:
                    if p["sends"] > self.max_retries:
                        exhausted = True
                        break
                    resend = True
        if exhausted:
            self._fail_pending(
                f"no completion after {self.max_retries} retransmits"
            )
            return
        if flush_stranded:
            self.flush()
        if resend:
            self._transmit(resend=True)

    def _on_frame(self, frame: dict) -> None:
        if frame.get("unit") != self.name:
            return
        kind = frame.get("kind")
        if kind == "heartbeat":
            # liveness already noted in the recv loop; keep the payload
            # (queue_depth / inflight) for membership + autoscaling eyes
            self.last_heartbeat = frame
            return
        if kind == "busy":
            # the worker is alive and executing this pending seq: the
            # retransmit budget bounds unresponsiveness, not work time
            with self._plock:
                p = self._pending.get(frame.get("seq"))
                if p is not None:
                    p["sends"] = 1
            return
        if kind == "unknown_fn":
            # the worker does not know this descriptor (registration lost
            # or worker restarted): re-register and retransmit right away.
            # sends keeps counting (unlike busy) so a poison registration
            # still exhausts into WorkerLost instead of looping forever.
            with self._plock:
                self._registered.discard(frame.get("fn_id"))
                p = self._pending.get(frame.get("seq"))
                if p is not None:
                    p["next_resend"] = 0.0
            return
        if kind == "done":
            self._on_done_item(frame)
        elif kind == "done_batch":
            for item in frame.get("items") or ():
                self._on_done_item(item)

    def _on_done_item(self, item: dict) -> None:
        with self._plock:
            p = self._pending.pop(item.get("seq"), None)
        if p is None:
            return  # duplicate/stale completion: drop on the floor
        t_sent = p["t_sent"] if p["t_sent"] is not None else p["t_submit"]
        t_start = item.get("t_start")
        if t_start is None:
            t_start = t_sent
        t_accept = item.get("t_accept")
        if t_accept is None:
            t_accept = t_start
        batch_n = max(int(p.get("batch_n") or 1), 1)
        # Per-chunk wire attribution: the frame's transit time
        # (send -> worker accept) is shared by every chunk in the frame,
        # so each chunk gets 1/batch_n of it; summed over a batch this
        # counts the frame's transit exactly once.  The wait on the worker
        # (accept -> execution start) stays in dispatch latency, not in
        # the wire: a hosted device unit counts its host enqueue there.
        wire = max(t_accept - t_sent, 0.0) / batch_n
        self.wire_latencies.append(wire)
        self.local_queue_latencies.append(max(t_sent - p["t_submit"], 0.0))
        if self.auto_batch:
            # Raw (undivided) frame transit vs. per-chunk service time:
            # the attributed per-chunk wire number above shrinks as the
            # batch grows, which would feed back into ever-smaller
            # targets; sizing needs the cost one frame actually pays.
            a = _AUTO_BATCH_ALPHA
            transit = max(t_accept - t_sent, 0.0)
            service = max(float(item.get("elapsed", 0.0)), 0.0)
            with self._plock:
                self._ewma_transit = (transit if self._ewma_transit is None
                                      else a * transit + (1 - a) * self._ewma_transit)
                self._ewma_service = (service if self._ewma_service is None
                                      else a * service + (1 - a) * self._ewma_service)
        self._post(CompletionRecord(
            unit=self.name, chunk=p["chunk"],
            elapsed=float(item.get("elapsed", 0.0)),
            dispatch_latency=max(t_start - p["t_submit"], 0.0),
            error=item.get("error"), result=item.get("result"),
        ))

    # -- failure ------------------------------------------------------------
    def _post_lost(self, chunk: Optional[Chunk], why: str,
                   error_cls: type = WorkerLost) -> None:
        self.lost = True
        bus = self._bus
        if bus is not None:
            bus.post(CompletionRecord(
                unit=self.name, chunk=chunk, elapsed=0.0, dispatch_latency=0.0,
                error=error_cls(f"unit {self.name!r}: {why}"), result=None,
            ))

    def _fail_pending(self, why: str, *, error_cls: type = WorkerLost) -> None:
        with self._plock:
            pending, self._pending = self._pending, OrderedDict()
            self._unsent = []
        self.lost = True
        self._stop.set()
        # one WorkerLost/WorkerDead is enough: the engine answers it by
        # removing the unit, which requeues *all* of its outstanding
        # chunks at once.  A heartbeat conviction with nothing pending
        # (idle unit) still posts — with chunk=None — so membership
        # observers learn of the death without waiting for a submit.
        first = next(iter(pending.values()), None)
        if first is not None:
            self._post_lost(first["chunk"], why, error_cls)
        elif error_cls is not WorkerLost:
            self._post_lost(None, why, error_cls)

    def describe(self) -> str:
        where = self.address if self.address is not None else "injected transport"
        return f"RemoteUnit({self.name!r} @ {where})"


# ---------------------------------------------------------------------------
# transportable work helpers
# ---------------------------------------------------------------------------
class SleepWork:
    """Per-item sleep work that survives the pickling transport.

    Work functions sent to a :class:`SocketTransport` worker unpickle *by
    module reference* on the far side, so they cannot live in a script's
    ``__main__`` (the worker has a different ``__main__``).  Benchmarks
    that model compute with calibrated sleeps import this instead.
    """

    def __init__(self, seconds_per_item: float) -> None:
        self.seconds_per_item = float(seconds_per_item)

    def __call__(self, chunk) -> None:
        time.sleep(chunk.size * self.seconds_per_item)


# ---------------------------------------------------------------------------
# worker subprocesses
# ---------------------------------------------------------------------------
_BANNER = "ENEAC_WORKER"


class WorkerHandle:
    """A spawned worker subprocess: its address and its lifetime."""

    def __init__(self, proc: subprocess.Popen, address: str) -> None:
        self.proc = proc
        self.address = address

    def terminate(self, timeout: float = 10.0) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.kill()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def __enter__(self) -> "WorkerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


def spawn_worker(*, host: str = "127.0.0.1",
                 startup_timeout: float = 60.0) -> WorkerHandle:
    """Launch ``python -m repro_torch.core.transport`` and wait for its address.

    The subprocess prints ``ENEAC_WORKER <host:port>`` once its listener
    is bound; this parses that line (with a timeout, so a worker that
    dies on import fails fast instead of hanging the caller) and returns
    a handle whose ``address`` plugs straight into
    ``register_unit(backend=f"remote:{handle.address}")``.

    The worker inherits the parent's ``sys.path``, because submitted
    work functions unpickle by module reference on the far side — the
    worker must be able to import whatever module defines them (test
    modules included).
    """
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    paths = [src_dir] + [p for p in sys.path if p and p != src_dir]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    entry = ("import sys; from repro_torch.core.transport import _main; "
             "sys.exit(_main(sys.argv[1:]))")
    proc = subprocess.Popen(
        [sys.executable, "-c", entry, "--host", host, "--port", "0"],
        stdout=subprocess.PIPE, text=True, env=env,
    )
    deadline = time.monotonic() + startup_timeout
    line = ""
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"worker subprocess exited with {proc.returncode} before "
                "announcing its address"
            )
        ready, _, _ = select.select([proc.stdout], [], [], 0.25)
        if not ready:
            continue
        line = proc.stdout.readline()
        if line.startswith(_BANNER):
            return WorkerHandle(proc, line.split()[1].strip())
        if not line:  # EOF without banner
            break
    proc.kill()
    raise RuntimeError(
        f"worker subprocess did not announce an address within "
        f"{startup_timeout}s (last line: {line!r})"
    )


def _main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve ENEAC remote backend units over TCP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed on stdout)")
    args = ap.parse_args(argv)
    server = WorkerServer(args.host, args.port)
    print(f"{_BANNER} {server.address}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(_main())

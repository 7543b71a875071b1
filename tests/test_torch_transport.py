"""The port's transport against ``repro.core.transport``, on the CPU.

The frame codec gives the same bytes in both packages and splits a
stream the same way however it is cut; a seeded ``FlakyTransport`` drops,
duplicates and reorders the same frames; a ``RemoteUnit`` over a lossy
medium covers every item exactly once, as the reference's does.  A real
worker process (``spawn_worker``) serves a ``parallel_for``, and refuses
a ``cuda`` unit on a host without a card with the ``error`` frame.  Where
the port's transport differs from the reference's: a send to a peer that
stopped reading fails within its bound, a completion that takes long to
arrive is sent once however often the client retransmits, and wire
latency is the frame's transit alone.
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.transport as jax_transport  # noqa: E402
from repro.core import HeteroRuntime as JaxHeteroRuntime  # noqa: E402
from repro_torch.core import HeteroRuntime, LoopbackTransport, RemoteUnit, WorkerKind  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.core.backends import REMOTE_SPEC_KNOBS, make_backend  # noqa: E402


def random_frames(seed, n=12):
    rng = np.random.default_rng(seed)
    kinds = ("submit", "done", "heartbeat", "work_batch", "hello")
    frames = []
    for i in range(n):
        frame = {"kind": kinds[int(rng.integers(len(kinds)))], "unit": f"u{i % 3}",
                 "seq": int(rng.integers(0, 1 << 40)), "t": float(rng.random()),
                 "items": [(int(a), int(a) + 8) for a in rng.integers(0, 1000, int(rng.integers(4)))]}
        if rng.random() < 0.5:
            frame["blob"] = rng.bytes(int(rng.integers(0, 5000)))
        frames.append(frame)
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frame_codec_bytes_equal_reference(seed):
    for frame in random_frames(seed):
        assert transport.encode_frame(frame) == jax_transport.encode_frame(frame)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_decoder_splits_random_cuts_as_reference(seed):
    frames = random_frames(seed, n=20)
    stream = b"".join(transport.encode_frame(f) for f in frames)
    rng = np.random.default_rng(100 + seed)
    cuts = np.sort(rng.choice(np.arange(1, len(stream)), 40, replace=False))
    pieces = np.split(np.frombuffer(stream, np.uint8), cuts)
    got = []
    for mod in (transport, jax_transport):
        dec, out = mod.FrameDecoder(), []
        for piece in pieces:
            out.append(dec.feed(piece.tobytes()))
        got.append(out)
    assert got[0] == got[1]
    assert [f for batch in got[0] for f in batch] == frames


def test_flaky_transport_faults_as_reference():
    delivered = []
    for mod in (transport, jax_transport):
        a, b = mod.LoopbackTransport.pair()
        flaky = mod.FlakyTransport(a, seed=7, drop=0.2, duplicate=0.2, reorder=0.2)
        for i in range(200):
            flaky.send({"kind": "submit", "seq": i})
        out = []
        while (frame := b.recv(timeout=0.0)) is not None:
            out.append(frame["seq"])
        delivered.append((out, dict(flaky.stats)))
    assert delivered[0] == delivered[1]
    assert delivered[0][1]["dropped"] > 0 and delivered[0][1]["duplicated"] > 0


def test_large_frame_survives_short_receive_polls():
    # one socket object serves a polling receiver and a sender at once, as
    # in a worker session; a 48 MB frame takes longer to drain than a poll
    a, b = socket.socketpair()
    near, far = transport.SocketTransport(a), transport.SocketTransport(b)
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            near.recv(timeout=0.001)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        blob = np.random.default_rng(0).bytes(48 << 20)
        sender = threading.Thread(target=near.send, args=({"kind": "done", "blob": blob},))
        sender.start()
        got = far.recv(timeout=60.0)
        sender.join(timeout=60.0)
        assert not sender.is_alive() and not near.closed
        assert got["blob"] == blob
    finally:
        stop.set()
        poller.join(timeout=10.0)
        near.close()
        far.close()
    assert not poller.is_alive()


def test_send_to_a_peer_that_stopped_reading_closes_within_its_bound():
    a, b = socket.socketpair()
    near = transport.SocketTransport(a, send_timeout=0.2)
    try:
        t0 = time.perf_counter()
        with pytest.raises(transport.TransportClosed, match="took no byte for 0.2s"):
            near.send({"kind": "submit", "blob": bytes(16 << 20)})
        assert time.perf_counter() - t0 < 5.0
        assert near.closed
    finally:
        near.close()
        b.close()


class SlowReads:
    """A socket whose every read waits 2 ms first: a frame of MBs trickles."""

    def __init__(self, sock):
        self._sock = sock

    def __getattr__(self, name):
        return getattr(self._sock, name)

    def recv(self, n):
        time.sleep(0.002)
        return self._sock.recv(n)


class CountingTransport(transport.Transport):
    """Records the seqs of every completion frame it sends."""

    def __init__(self, inner):
        self.inner, self.done_seqs = inner, []

    def send(self, frame):
        if frame.get("kind") == "done":
            self.done_seqs.append(frame["seq"])
        elif frame.get("kind") == "done_batch":
            self.done_seqs.extend(item["seq"] for item in frame["items"])
        self.inner.send(frame)

    def recv(self, timeout=None):
        return self.inner.recv(timeout)

    def close(self):
        self.inner.close()

    @property
    def closed(self):
        return self.inner.closed


class BlobWork:
    """Returns 8 MB per chunk, as a remote prefill returns its cache."""

    def __call__(self, chunk):
        return bytes(8 << 20)


def test_large_completion_under_retransmits_is_sent_once():
    # the client retransmits every 10 ms while each 8 MB completion takes
    # hundreds of ms to read: it must get one copy of each, not one per
    # retransmit, and cover every item exactly once
    a, b = socket.socketpair()
    worker_end = CountingTransport(transport.SocketTransport(b))
    worker = transport.RemoteWorker(worker_end, poll_interval=0.02)
    threading.Thread(target=worker.serve, daemon=True).start()
    unit = RemoteUnit("big", transport=transport.SocketTransport(SlowReads(a)),
                      retry_interval=0.01, max_retries=1000)
    rt = HeteroRuntime()
    rt.register_unit("big", WorkerKind.ACC, work_fn=BlobWork(), backend=unit)
    try:
        rep = rt.parallel_for(num_items=3, policy="multidynamic", acc_chunk=1)
    finally:
        worker.stop()
        unit.close()
    assert rep.items == 3 and rep.coverage == [(0, 1), (1, 2), (2, 3)]
    assert sorted(worker_end.done_seqs) == sorted(set(worker_end.done_seqs))
    assert len(worker_end.done_seqs) == 3


def test_remote_wire_latency_is_the_transit_alone():
    # two chunks share a frame to a worker with one thread: the second
    # waits there ~100 ms before it starts.  That wait is dispatch latency;
    # the wire is the frame's transit alone
    client, worker_end = LoopbackTransport.pair()
    worker = transport.RemoteWorker(worker_end, poll_interval=0.02)
    threading.Thread(target=worker.serve, daemon=True).start()
    unit = RemoteUnit("w0", transport=client, batch_frames=2)
    rt = HeteroRuntime()
    rt.register_unit("w0", WorkerKind.ACC, backend=unit)
    try:
        rt.parallel_for(transport.SleepWork(0.1), num_items=4, policy="multidynamic", acc_chunk=1)
    finally:
        worker.stop()
    waits = [d - q for d, q in zip(unit.dispatch_latencies, unit.local_queue_latencies)]
    assert max(waits) >= 0.08
    assert max(unit.wire_latencies) < 0.04


class Recorder:
    """Counts how often each item was executed (must be once)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = {}

    def __call__(self, chunk):
        with self.lock:
            for i in chunk.indices():
                self.counts[i] = self.counts.get(i, 0) + 1


def lossy_run(mod, runtime_cls, n_items=180, seed=1234):
    rec = Recorder()
    rt = runtime_cls()
    for i in range(2):
        client, worker_end = mod.LoopbackTransport.pair()
        worker = mod.RemoteWorker(
            mod.FlakyTransport(worker_end, seed=seed + 10 + i, drop=0.2, duplicate=0.2,
                               reorder=0.2), poll_interval=0.02)
        threading.Thread(target=worker.serve, daemon=True).start()
        unit = mod.RemoteUnit(f"r{i}", transport=mod.FlakyTransport(
            client, seed=seed + i, drop=0.2, duplicate=0.2, reorder=0.2),
            retry_interval=0.02, max_retries=400)
        rt.register_unit(f"r{i}", "cc", work_fn=rec, backend=unit)
    rep = rt.parallel_for(num_items=n_items, policy="static", acc_chunk=8)
    return rep, rec


def test_remote_units_under_loss_cover_exactly_once_as_reference():
    rep, rec = lossy_run(transport, HeteroRuntime)
    ref_rep, ref_rec = lossy_run(jax_transport, JaxHeteroRuntime)
    assert rec.counts == {i: 1 for i in range(180)} == ref_rec.counts
    assert rep.items == ref_rep.items == 180
    assert rep.coverage == ref_rep.coverage
    assert rep.per_worker_items == ref_rep.per_worker_items


def test_remote_spec_names_the_hosted_backend():
    assert "backend" in REMOTE_SPEC_KNOBS
    unit = make_backend("remote:127.0.0.1:9?backend=cuda&heartbeat=0.5&patience=4", "r0")
    assert isinstance(unit, RemoteUnit)
    assert (unit.remote_backend, unit.heartbeat, unit.patience) == ("cuda", 0.5, 4)
    assert make_backend("remote:127.0.0.1:9", "r1").remote_backend == "thread"
    with pytest.raises(ValueError, match="remote_backend must be one of"):
        make_backend("remote:127.0.0.1:9?backend=jax", "r2")
    with pytest.raises(ValueError, match="unknown remote backend knob"):
        make_backend("remote:127.0.0.1:9?device=cuda", "r3")


def test_loopback_worker_hosts_cuda_units_or_refuses():
    client, worker_end = LoopbackTransport.pair()
    worker = transport.RemoteWorker(worker_end, poll_interval=0.02)
    threading.Thread(target=worker.serve, daemon=True).start()
    unit = RemoteUnit("g0", transport=client, remote_backend="cuda", connect_timeout=5.0)
    rt = HeteroRuntime()
    rt.register_unit("g0", WorkerKind.ACC, work_fn=lambda c: None, backend=unit)
    if torch.cuda.is_available():
        assert rt.parallel_for(num_items=16, acc_chunk=4).items == 16
    else:
        with pytest.raises(transport.TransportError, match="cannot start backend 'cuda'"):
            rt.parallel_for(num_items=16, acc_chunk=4)
    worker.stop()


@pytest.fixture
def worker():
    handle = transport.spawn_worker(startup_timeout=60.0)
    try:
        yield handle
    finally:
        handle.kill()
    assert not handle.alive


def test_spawned_worker_serves_parallel_for_exactly_once(worker):
    rt = HeteroRuntime()
    for i in range(2):
        rt.register_unit(f"r{i}", WorkerKind.CC, backend=f"remote:{worker.address}")
    rep = rt.parallel_for(transport.SleepWork(1e-4), num_items=240, policy="multidynamic",
                          acc_chunk=8)
    spans = rep.coverage
    assert rep.items == 240 and spans[0][0] == 0 and spans[-1][1] == 240
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert set(rep.wire_latency) == {"r0", "r1"}
    if not torch.cuda.is_available():
        unit = RemoteUnit("g0", address=worker.address, remote_backend="cuda")
        rt.register_unit("g0", WorkerKind.ACC, backend=unit)
        with pytest.raises(transport.TransportError, match="CudaStreamUnit 'g0' needs a CUDA"):
            rt.parallel_for(transport.SleepWork(1e-4), num_items=16, units=["g0"])

"""The port's copied scheduling core against ``repro.core``, and CudaStreamUnit.

Under a ``SimulatedClock`` both cores are deterministic, so the same units,
speeds and item costs must give the same ``RunReport`` field for field.
``CudaStreamUnit(device="cpu")`` passes the counterparts of the reference's
jax-unit tests; on a CUDA device it raises when there is no card.  The unit
is driven on a card in ``test_torch_cuda.py``.
"""

import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CompletionBus,
    CudaStreamUnit,
    HeteroRuntime,
    ThreadUnit,
    WorkerKind,
)
from repro_torch.core.backends import make_backend  # noqa: E402
from repro_torch.core.runtime import ENGINES, POLICIES  # noqa: E402
from repro_torch.core.scheduler import Chunk  # noqa: E402

FIELDS = ("items", "chunks", "coverage", "per_worker_items", "per_worker_chunks",
          "per_worker_busy", "load_balance", "wall_time", "events")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's parallel workers share the host with wall-clock timing
    tests, so these tests keep PyTorch's CPU ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def simulated_runtime(pkg, *, cost_model=False):
    rt = pkg.HeteroRuntime(clock=pkg.SimulatedClock(),
                           cost_model=pkg.CostModel() if cost_model else None)
    for i, speed in enumerate((8e3, 5e3)):
        rt.register_unit(f"acc{i}", pkg.WorkerKind.ACC, speed=speed)
    for i, speed in enumerate((1e3, 7e2, 1.3e3)):
        rt.register_unit(f"cc{i}", pkg.WorkerKind.CC, speed=speed)
    return rt


def costs(n, seed=0):
    return np.random.default_rng(seed).zipf(1.5, n).clip(max=50.0).astype(float)


def assert_same_report(a, b):
    for field in FIELDS:
        assert getattr(a, field) == getattr(b, field), field
    assert a.makespan == b.makespan


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", ["multidynamic", "static", "oracle", "learned"])
def test_simulated_report_equals_reference(policy, engine):
    assert POLICIES == jax_core.runtime.POLICIES
    reports = []
    for pkg in (jax_core, core):
        rt = simulated_runtime(pkg, cost_model=policy == "learned")
        seen = []
        kw = dict(policy=policy, engine=engine, acc_chunk=64, item_cost=costs(997))
        if policy == "learned":  # the cold-start run that teaches the cost model
            rt.parallel_for(lambda c: None, 997, **kw)
        rep = rt.parallel_for(lambda c: seen.append((c.start, c.stop)), 997, **kw)
        reports.append((rep, sorted(seen)))
    (ref_rep, ref_seen), (rep, seen) = reports
    assert_same_report(rep, ref_rep)
    assert seen == ref_seen


def test_simulated_elastic_report_equals_reference():
    reports = []
    for pkg in (jax_core, core):
        rt = simulated_runtime(pkg)
        events = [pkg.ElasticEvent(t=0.02, action="leave", unit="acc1"),
                  pkg.ElasticEvent(t=0.05, action="join", unit="acc9",
                                   kind=pkg.WorkerKind.ACC, speed=6e3)]
        reports.append(rt.parallel_for(lambda c: None, 2000, acc_chunk=32,
                                       item_cost=costs(2000, seed=1), elastic=events))
    assert_same_report(reports[1], reports[0])


def test_core_exports_only_what_was_copied():
    assert "CudaStreamUnit" in core.__all__
    assert "JaxDeviceUnit" not in core.__all__ and not hasattr(core, "JaxDeviceUnit")
    for ported in ("RemoteUnit", "FleetManager", "spawn_worker", "WorkerHandle",
                   "LoopbackTransport", "SocketTransport", "FlakyTransport"):
        assert ported in core.__all__ and hasattr(core, ported)
    assert set(jax_core.__all__) - set(core.__all__) == {"JaxDeviceUnit"}


# ---------------------------------------------------------------------------
# CudaStreamUnit on the CPU (the counterparts of the jax-unit tests)
# ---------------------------------------------------------------------------
def drive(unit, chunks, work_fn):
    bus = CompletionBus()
    unit.start(bus)
    try:
        recs = []
        for c in chunks:
            unit.submit(c, work_fn)
            assert bus.wait(timeout=10.0)
            recs.extend(bus.drain())
        return recs
    finally:
        unit.close()


def test_cpu_unit_dispatches_torch_work():
    unit = CudaStreamUnit("d0", device="cpu")
    recs = drive(unit, [Chunk(0, 8, "d0"), Chunk(8, 11, "d0")],
                 lambda c: (torch.arange(c.start, c.stop, dtype=torch.float32) * 2.0).sum())
    assert [float(r.result) for r in recs] == [56.0, 2.0 * (8 + 9 + 10)]
    assert all(r.error is None and r.dispatch_latency >= 0 for r in recs)
    assert len(unit.dispatch_latencies) == 2


def test_cpu_unit_runs_off_the_caller_thread_and_restarts():
    unit = CudaStreamUnit("d0", device="cpu")
    caller = threading.get_ident()
    r1 = drive(unit, [Chunk(0, 1, "d0")], lambda c: threading.get_ident())
    r2 = drive(unit, [Chunk(1, 2, "d0")], lambda c: c.size)
    assert r1[0].result != caller and r2[0].result == 1


def test_cpu_unit_captures_errors():
    def boom(c):
        raise RuntimeError("kaput")

    recs = drive(CudaStreamUnit("d0", device="cpu"), [Chunk(0, 1, "d0")], boom)
    assert isinstance(recs[0].error, RuntimeError)


class Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.counts = Counter()

    def __call__(self, chunk):
        with self.lock:
            self.counts.update(chunk.indices())


def test_cpu_unit_report_identical_to_thread_unit():
    def run(backend):
        rec = Recorder()
        rt = HeteroRuntime()
        rt.register_unit("u0", WorkerKind.CC, work_fn=rec, backend=backend)
        rep = rt.parallel_for(num_items=96, policy={"u0": (0, 96)}, engine="interrupt")
        return rep, rec

    rep_cuda, rec_cuda = run(CudaStreamUnit("u0", device="cpu"))
    rep_thr, rec_thr = run("thread")
    assert rec_cuda.counts == rec_thr.counts == Counter(range(96))
    for field in ("items", "chunks", "coverage", "per_worker_items", "per_worker_chunks"):
        assert getattr(rep_cuda, field) == getattr(rep_thr, field), field
    assert set(rep_cuda.dispatch_latency) == set(rep_thr.dispatch_latency)
    assert rep_cuda.wire_latency is None and rep_thr.wire_latency is None


def test_cuda_unit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    unit = CudaStreamUnit("d0")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        unit.start(CompletionBus())
    rt = HeteroRuntime()
    rt.register_unit("d0", WorkerKind.ACC, work_fn=lambda c: None, backend="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        rt.parallel_for(num_items=8, engine="interrupt")


def test_cuda_unit_rejects_other_devices():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        CudaStreamUnit("d0", device="meta")


def test_make_backend_specs():
    assert isinstance(make_backend("cuda", "g0"), CudaStreamUnit)
    assert isinstance(make_backend(None, "t0"), ThreadUnit)
    remote = make_backend("remote:127.0.0.1:9", "r0")
    assert isinstance(remote, core.RemoteUnit) and remote.address == "127.0.0.1:9"
    assert remote.remote_backend == "thread"
    with pytest.raises(ValueError, match="'cuda'"):
        make_backend("jax", "j0")
    with pytest.raises(ValueError, match="names must match"):
        make_backend(CudaStreamUnit("a", device="cpu"), "b")

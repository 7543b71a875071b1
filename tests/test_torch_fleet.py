"""The port's fleet membership against ``repro.core.fleet``, on the CPU.

``simulate_fleet``, ``HeartbeatBook`` and ``Autoscaler`` are deterministic
in their inputs, so the same seeded trace gives the same results field
for field in both packages.  ``FleetManager`` registers units hosting
``cuda`` unless told otherwise, and a real worker that freezes mid-run is
convicted by missed heartbeats while the run covers each item once.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import FleetManager, HeteroRuntime  # noqa: E402
from repro_torch.core.transport import SleepWork  # noqa: E402

SIM_FIELDS = ("seed", "book_events", "convicted", "false_convictions", "missed_crashes",
              "conviction_delay", "survivors")
REPORT_FIELDS = ("items", "chunks", "coverage", "per_worker_items", "per_worker_busy",
                 "events", "wall_time")


def trace_tuple(tr):
    return (tr.seed, tr.initial_units, tr.horizon,
            [(e.t, e.action, e.unit, e.factor) for e in tr.events])


@pytest.mark.parametrize("seed", [0, 3, 5, 11, 42])
def test_simulate_fleet_equals_reference(seed):
    got = core.simulate_fleet(seed, num_units=60, heartbeat=0.05, patience=3, horizon=6.0)
    want = jax_core.simulate_fleet(seed, num_units=60, heartbeat=0.05, patience=3,
                                   horizon=6.0)
    assert trace_tuple(got.trace) == trace_tuple(want.trace)
    for field in SIM_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert ([(e.t, e.action, e.unit) for e in got.schedule.events]
            == [(e.t, e.action, e.unit) for e in want.schedule.events])
    for field in REPORT_FIELDS:
        assert getattr(got.report, field) == getattr(want.report, field), field
    assert not got.false_convictions and not got.missed_crashes


def test_heartbeat_book_equals_reference():
    books = [pkg.HeartbeatBook(heartbeat=0.1, patience=3) for pkg in (core, jax_core)]
    units = [f"u{i}" for i in range(8)]
    swept = [[], []]
    for b, book in enumerate(books):
        t = 0.0
        for u in units:
            book.join(t, u)
        steps = np.random.default_rng(9)
        for _ in range(400):
            t += float(steps.exponential(0.03))
            u = units[int(steps.integers(len(units)))]
            if steps.random() < 0.9 and int(u[1:]) % 3:  # u0, u3, u6 fall silent
                book.beat(t, u, queue_depth=int(steps.integers(10)), inflight=1)
            swept[b].append(book.sweep(t))
    assert swept[0] == swept[1]
    assert books[0].events == books[1].events
    assert books[0].members == books[1].members
    assert books[0].queue_depth() == books[1].queue_depth()
    assert {"u0", "u3", "u6"} <= {e["unit"] for e in books[0].events if e["action"] == "dead"}


def test_autoscaler_equals_reference():
    decisions = []
    for pkg in (core, jax_core):
        cm = pkg.CostModel()
        for u, items in (("u0", 120), ("u1", 80), ("u2", 100)):
            cm.observe(u, "k", items=items, elapsed=1.0)
        scaler = pkg.Autoscaler(cm, kernel="k", horizon=2.0, min_units=1, max_units=12,
                                cooldown_s=0.5)
        rng = np.random.default_rng(2)
        n, out = 2, []
        for step in range(60):
            delta = scaler.decide(step * 0.2, queue_depth=int(rng.integers(0, 3000)),
                                  n_units=n)
            n += delta
            out.append((delta, scaler.target(int(rng.integers(0, 3000)))))
        decisions.append(out)
    assert decisions[0] == decisions[1]
    assert any(d > 0 for d, _ in decisions[0]) and any(d < 0 for d, _ in decisions[0])


class FakeHandle:
    def __init__(self):
        self.address = "127.0.0.1:9"
        self.alive = True

    def terminate(self):
        self.alive = False

    kill = terminate


def test_fleet_manager_units_host_cuda_unless_told():
    rt = HeteroRuntime()
    fm = FleetManager(rt, heartbeat=0.25, patience=4, spawn=FakeHandle)
    name = fm.spawn_unit()
    spec = rt.units[name].backend
    assert "heartbeat=0.25" in spec and "patience=4" in spec and "backend=cuda" in spec
    fm.shutdown()
    fm = FleetManager(rt, spawn=FakeHandle, remote_backend="thread")
    name = fm.spawn_unit()
    assert rt.units[name].backend.endswith("&backend=thread")
    fm.shutdown()
    assert not rt.units


def test_frozen_worker_is_convicted_by_heartbeat():
    rt = HeteroRuntime()
    with FleetManager(rt, heartbeat=0.2, patience=5, remote_backend="thread") as fm:
        fm.scale_to(2)
        victim = fm.members[-1]
        pid = fm.handle(victim).proc.pid
        freeze = threading.Timer(0.3, os.kill, args=(pid, signal.SIGSTOP))
        freeze.start()
        try:
            t0 = time.perf_counter()
            rep = rt.parallel_for(SleepWork(2e-3), num_items=1200, policy="multidynamic",
                                  acc_chunk=8)
        finally:
            freeze.cancel()
        assert time.perf_counter() - t0 > 0.3, "the run ended before the freeze"
        fm.kill_unit(victim)
        assert fm.reap() == [victim]
    spans = rep.coverage
    assert rep.items == 1200 and spans[0][0] == 0 and spans[-1][1] == 1200
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
    losses = [e for e in rep.events or () if e["action"] in ("lost", "dead")]
    assert [(e["unit"], e["action"]) for e in losses] == [(victim, "dead")]
    assert len(fm) == 0

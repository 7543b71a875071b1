"""Hybrid dense/sparse ``parallel_for`` over an irregular iteration space.

Within a single TPU chip, the ENEAC "ACC vs CC" pairing maps onto the two
compute units that actually exist: the MXU (systolic 128×128 matmuls —
high throughput, rigid tile shapes) and the VPU/gather path (flexible,
much lower throughput).  For an irregular workload like SPMM, rows with
enough density to fill dense tiles belong on the MXU; the long sparse tail
is cheaper via gathers.  The split point is the scheduling decision, and
MultiDynamic's measure-and-adapt loop chooses it.

:class:`HybridExecutor` owns that decision as a thin client of
:class:`~repro.core.runtime.HeteroRuntime`: the MXU path registers as an
ACC unit, the gather path as a CC unit, the runtime's oracle policy turns
measured throughputs into the balanced split, and each round executes
through ``runtime.parallel_for`` so the throughput feedback loop shares
the engine bookkeeping (busy times, coverage, utilization) with every
other workload.

* ``"parallel"`` — units overlap (multi-device via shard_map, or
  MXU/VPU co-issue inside one fused kernel): cost = max(t_dense, t_sparse)
  ⇒ balance the split (the paper's load-balance objective).
* ``"serial"`` — units serialize (single stream): cost = sum ⇒ each item
  goes to whichever path is cheaper *for it* (threshold on density).

Both reduce to the paper's scheme: a tunable accelerator chunk and a
dynamically-adapted remainder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from .hetero import ThroughputTracker
from .runtime import HeteroRuntime
from .scheduler import WorkerKind

__all__ = ["SplitDecision", "HybridExecutor"]


@dataclasses.dataclass(frozen=True)
class SplitDecision:
    n_dense: int            # items sent to the MXU/accelerator path
    n_sparse: int           # items on the VPU/core path
    predicted_time: float

    @property
    def dense_fraction(self) -> float:
        tot = self.n_dense + self.n_sparse
        return self.n_dense / tot if tot else 0.0


class HybridExecutor:
    """MultiDynamic split-point controller + runner for two-path workloads.

    ``dense_fn(items) -> result`` and ``sparse_fn(items) -> result`` each
    process a *prefix count* of the (pre-sorted, densest-first) iteration
    space; ``merge_fn`` combines the two partial results.
    """

    def __init__(
        self,
        dense_fn: Callable[[int], object],
        sparse_fn: Callable[[int], object],
        merge_fn: Callable[[object, object], object],
        num_items: int,
        *,
        mode: str = "parallel",
        dense_quantum: int = 8,
        init_dense_throughput: float = 8.0,
        init_sparse_throughput: float = 1.0,
    ) -> None:
        if mode not in ("parallel", "serial"):
            raise ValueError(f"mode must be parallel|serial, got {mode!r}")
        self.dense_fn = dense_fn
        self.sparse_fn = sparse_fn
        self.merge_fn = merge_fn
        self.num_items = num_items
        self.mode = mode
        self.dense_quantum = dense_quantum
        self.tracker = ThroughputTracker(alpha=0.4)
        self.tracker.update("dense", init_dense_throughput, 1.0)
        self.tracker.update("sparse", init_sparse_throughput, 1.0)
        self._results: dict = {}
        self.runtime = HeteroRuntime()
        # dense first: the runtime's prefix split then maps "dense" to the
        # leading (densest) rows, which is what the path callables expect.
        self.runtime.register_unit(
            "dense", WorkerKind.ACC,
            work_fn=lambda c: self._results.__setitem__("dense", self.dense_fn(c.size)),
        )
        self.runtime.register_unit(
            "sparse", WorkerKind.CC,
            work_fn=lambda c: self._results.__setitem__("sparse", self.sparse_fn(c.size)),
        )

    def _sync_speeds(self) -> Tuple[float, float]:
        td = self.tracker.get("dense")
        ts = self.tracker.get("sparse")
        self.runtime.set_speed("dense", td)
        self.runtime.set_speed("sparse", ts)
        return td, ts

    # -- the scheduling decision -------------------------------------------
    def decide(self) -> SplitDecision:
        td, ts = self._sync_speeds()
        n = self.num_items
        if self.mode == "parallel":
            # balance: n_d/td == n_s/ts — the runtime's throughput-
            # proportional (oracle) split over the two units.
            plan = self.runtime.plan(n, policy="oracle")
            lo, hi = plan.get("dense", (0, 0))
            nd = hi - lo
        else:
            # serial: everything goes to the faster path; the split only
            # helps when per-item costs differ — callers sort densest-first
            # so a prefix split is optimal for either ordering.
            nd = n if td >= ts else 0
        nd = int(round(nd / self.dense_quantum)) * self.dense_quantum
        nd = max(0, min(n, nd))
        ns = n - nd
        if self.mode == "parallel":
            pred = max(nd / max(td, 1e-12), ns / max(ts, 1e-12))
        else:
            pred = nd / max(td, 1e-12) + ns / max(ts, 1e-12)
        return SplitDecision(n_dense=nd, n_sparse=ns, predicted_time=pred)

    # -- execution + feedback -------------------------------------------------
    def run(self, decision: Optional[SplitDecision] = None) -> Tuple[object, SplitDecision]:
        d = decision or self.decide()
        self._results.clear()
        rep = self.runtime.parallel_for(
            num_items=self.num_items,
            policy={"dense": (0, d.n_dense),
                    "sparse": (d.n_dense, self.num_items)},
            engine="inline",
        )
        for path in ("dense", "sparse"):
            items = rep.per_worker_items.get(path, 0)
            if items:
                self.tracker.update(path, items, rep.per_worker_busy[path])
        merged = self.merge_fn(self._results.get("dense"), self._results.get("sparse"))
        return merged, d

    def converge(self, rounds: int = 5) -> SplitDecision:
        """Run the measure→rebalance loop until the split stabilizes."""
        last = None
        for _ in range(rounds):
            _, last = self.run()
        return last if last is not None else self.decide()

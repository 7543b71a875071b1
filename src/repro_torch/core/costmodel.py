"""Online per-(unit, kernel) cost model — measured capability descriptors.

The oracle/static policies split the iteration space from *user-supplied*
throughputs; the paper can do that because it calibrates each FPGA block
offline.  Production units drift (thermal throttling, contended hosts,
changed kernels), so the ROADMAP's answer is to *measure*: every
:class:`~repro.core.interrupts.RunReport` already carries per-unit items,
busy time, dispatch latency, and wire latency — exactly the observations
a per-(unit, kernel) capability descriptor needs.  This module turns that
history into a reusable model, in the shape of lumos's per-unit-class
``HeterogSys`` budgets and the Zynq coarse-grain performance estimator
(arXiv:1508.06830):

* :class:`CostEntry` — the capability descriptor for one (unit, kernel)
  pair: EWMA throughput (items/s), EWMA dispatch latency, EWMA wire
  latency, and the sample/item counts behind them.
* :class:`CostModel` — the store: ``observe_report(report, kernel)``
  folds a finished run in (the runtime calls it after every
  ``parallel_for``), ``lookup(unit, kernel)`` returns the descriptor,
  ``speeds(units, kernel)`` feeds the ``policy="learned"`` split, and
  ``save()``/construction-time load persist the model across runs as a
  versioned JSON artifact (schema :data:`STORE_SCHEMA`).  A corrupted or
  version-mismatched store never crashes a run: it warns
  (:class:`CostModelWarning`) and cold-starts.

Shard handling: a :class:`~repro.core.space.ShardedSpace` run namespaces
its merged per-unit maps ``s{k}/{unit}``, but the physical unit behind
``s0/acc0`` and the one behind a later non-sharded ``acc0`` run are the
same resource.  :func:`base_unit_name` strips the shard prefix before
any observation lands, so one physical unit never fragments into ``k``
phantom entries (pinned by ``tests/test_costmodel.py``).

Everything here is pure host-side bookkeeping — no jax, no threads of
its own; a single lock makes observation safe from engine callbacks.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import warnings
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CostEntry",
    "CostModel",
    "CostModelWarning",
    "STORE_SCHEMA",
    "base_unit_name",
]

STORE_SCHEMA = "costmodel/v1"

# Merged shard reports prefix unit keys "s{k}/"; one level, never nested.
_SHARD_PREFIX = re.compile(r"^s\d+/")


class CostModelWarning(UserWarning):
    """A persisted cost store could not be used and was cold-started."""


def base_unit_name(name: str) -> str:
    """Strip a ``s{k}/`` shard prefix: the physical unit's stable key.

    ``s0/acc0`` and ``s3/acc0`` are shard-engine views of the same
    ``acc0`` resource; learning must merge them, not fragment them.
    Names that carry no shard prefix pass through unchanged.
    """
    return _SHARD_PREFIX.sub("", name)


@dataclass
class CostEntry:
    """Capability descriptor for one (unit, kernel) pair.

    ``throughput`` is items/second, EWMA over run-level observations;
    ``dispatch_latency`` / ``wire_latency`` are EWMA seconds (None until
    the backend layer has produced a sample — simulated runs never do).
    ``samples`` counts observations, ``items`` the cumulative items they
    covered.
    """

    unit: str
    kernel: str
    throughput: Optional[float] = None
    dispatch_latency: Optional[float] = None
    wire_latency: Optional[float] = None
    samples: int = 0
    items: int = 0

    def seconds_for(self, items: int) -> Optional[float]:
        """Predicted execution seconds for ``items`` on this unit."""
        if not self.throughput:
            return None
        return items / self.throughput

    def overhead(self) -> float:
        """Fixed per-chunk seconds before work lands on the unit.

        Dispatch latency (submit -> executing) already *contains* the
        outbound wire time for remote units, so the two terms are not
        additive: take the larger of the learned values.  0.0 when the
        backend layer has produced no latency sample (simulated runs).
        """
        return max(self.dispatch_latency or 0.0, self.wire_latency or 0.0, 0.0)

    def predict(self, items: int, *, chunks: int = 1) -> Optional[float]:
        """Predicted completion seconds for ``items`` issued as ``chunks``
        dispatches: execution time plus per-chunk dispatch+wire overhead.
        None until a throughput has been learned."""
        exec_s = self.seconds_for(items)
        if exec_s is None:
            return None
        return exec_s + max(int(chunks), 0) * self.overhead()


class CostModel:
    """EWMA cost store learned from :class:`RunReport` history.

    ``path`` enables persistence: an existing store is loaded eagerly at
    construction (corruption or a schema mismatch warns and cold-starts
    instead of raising — a stale store must never block a run) and
    :meth:`save` writes the current state back atomically.  ``alpha`` is
    the EWMA smoothing factor shared by every entry.
    """

    def __init__(self, path: Optional[str] = None, *, alpha: float = 0.4) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.path = os.fspath(path) if path is not None else None
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], CostEntry] = {}
        if self.path is not None and os.path.exists(self.path):
            self._load(self.path)

    # -- observation ---------------------------------------------------------
    def _entry(self, unit: str, kernel: str) -> CostEntry:
        key = (base_unit_name(unit), str(kernel))
        entry = self._entries.get(key)
        if entry is None:
            entry = CostEntry(unit=key[0], kernel=key[1])
            self._entries[key] = entry
        return entry

    def _ewma(self, prev: Optional[float], value: float) -> float:
        if prev is None:
            return value
        return self.alpha * value + (1 - self.alpha) * prev

    def observe(self, unit: str, kernel: str, *, items: int, elapsed: float) -> float:
        """Record ``items`` completed in ``elapsed`` busy seconds; returns
        the updated EWMA throughput (items/s)."""
        if items <= 0:
            raise ValueError(f"items must be positive, got {items}")
        inst = items / max(elapsed, 1e-12)
        with self._lock:
            entry = self._entry(unit, kernel)
            entry.throughput = self._ewma(entry.throughput, inst)
            entry.samples += 1
            entry.items += int(items)
            return entry.throughput

    def observe_latency(
        self, unit: str, kernel: str, *,
        dispatch: Optional[float] = None, wire: Optional[float] = None,
    ) -> None:
        """Fold backend-layer latency samples (seconds) into the entry."""
        with self._lock:
            entry = self._entry(unit, kernel)
            if dispatch is not None:
                entry.dispatch_latency = self._ewma(entry.dispatch_latency,
                                                    float(dispatch))
            if wire is not None:
                entry.wire_latency = self._ewma(entry.wire_latency, float(wire))

    def observe_report(self, report, kernel: str = "default") -> None:
        """Fold one finished run into the model.

        Per-unit items/busy become a throughput observation; the
        ``dispatch_latency`` / ``wire_latency`` maps become latency
        observations.  Shard-prefixed keys (``s{k}/unit``) are merged
        onto the physical unit name *before* the EWMA update: items and
        busy time sum across shards, latencies average across the shard
        replicas that produced samples.
        """
        items: Dict[str, int] = {}
        busy: Dict[str, float] = {}
        for name, n in (report.per_worker_items or {}).items():
            items[base_unit_name(name)] = items.get(base_unit_name(name), 0) + n
        for name, b in (report.per_worker_busy or {}).items():
            busy[base_unit_name(name)] = busy.get(base_unit_name(name), 0.0) + b
        for name, n in items.items():
            if n > 0 and busy.get(name, 0.0) > 0.0:
                self.observe(name, kernel, items=n, elapsed=busy[name])
        for attr, field in (("dispatch_latency", "dispatch"),
                            ("wire_latency", "wire")):
            merged: Dict[str, List[float]] = {}
            for name, v in (getattr(report, attr, None) or {}).items():
                merged.setdefault(base_unit_name(name), []).append(float(v))
            for name, vals in merged.items():
                if name in items and items[name] > 0:
                    self.observe_latency(
                        name, kernel, **{field: sum(vals) / len(vals)}
                    )

    def forget(self, unit: str, kernel: Optional[str] = None) -> None:
        """Drop entries for ``unit`` (one kernel, or all when None)."""
        base = base_unit_name(unit)
        with self._lock:
            gone = [k for k in self._entries
                    if k[0] == base and (kernel is None or k[1] == kernel)]
            for k in gone:
                del self._entries[k]

    # -- queries -------------------------------------------------------------
    def lookup(self, unit: str, kernel: str) -> Optional[CostEntry]:
        """The capability descriptor for (unit, kernel), or None (a copy —
        callers cannot corrupt the model through it)."""
        with self._lock:
            entry = self._entries.get((base_unit_name(unit), str(kernel)))
            return CostEntry(**asdict(entry)) if entry is not None else None

    def throughput(self, unit: str, kernel: str,
                   default: Optional[float] = None) -> Optional[float]:
        entry = self.lookup(unit, kernel)
        if entry is None or entry.throughput is None:
            return default
        return entry.throughput

    def speeds(self, units: Sequence[str], kernel: str) -> Dict[str, float]:
        """Learned items/s for the given units — only those with data.

        The ``policy="learned"`` split uses this: when every unit has an
        entry the split is an oracle-style proportional pre-split over
        *measured* speeds; missing units mean cold start (adaptive
        fallback).
        """
        out: Dict[str, float] = {}
        for name in units:
            tp = self.throughput(name, kernel)
            if tp is not None and tp > 0:
                out[name] = tp
        return out

    def coverage(self, units: Sequence[str], kernel: str) -> bool:
        """True when every unit has a learned throughput for ``kernel``."""
        return len(self.speeds(units, kernel)) == len(set(units))

    def overheads(self, units: Sequence[str], kernel: str) -> Dict[str, float]:
        """Learned per-chunk dispatch+wire seconds for the given units.

        Every requested unit gets an entry (0.0 when nothing has been
        learned) — the latency-aware split treats missing data as free
        dispatch rather than excluding the unit.
        """
        out: Dict[str, float] = {}
        for name in units:
            entry = self.lookup(name, kernel)
            out[name] = entry.overhead() if entry is not None else 0.0
        return out

    def fleet_throughput(self, kernel: str) -> Optional[float]:
        """Mean learned items/s across units for ``kernel`` (None if no
        data) — the aggregate a serving admission policy predicts with.
        A measured 0.0 (stalled unit) counts as an observation; the
        result is floored so callers can divide by it."""
        with self._lock:
            vals = [e.throughput for (u, k), e in self._entries.items()
                    if k == kernel and e.throughput is not None]
        if not vals:
            return None
        return max(sum(vals) / len(vals), 1e-9)

    def predict_drain(self, kernel: str, items: int,
                      n_units: int) -> Optional[float]:
        """Predicted seconds to drain ``items`` across ``n_units`` workers.

        Uses the mean learned per-unit throughput for ``kernel``
        (:meth:`fleet_throughput`), so the estimate is for a fleet of
        *typical* units — the question an autoscaler asks ("at the
        current size, how long until the queue empties?"), not a
        per-unit placement question.  ``None`` until the model has at
        least one observation for the kernel.
        """
        if items <= 0:
            return 0.0
        if n_units <= 0:
            return math.inf
        per_unit = self.fleet_throughput(kernel)
        if per_unit is None:
            return None
        return float(items) / (per_unit * n_units)

    def kernels(self) -> List[str]:
        with self._lock:
            return sorted({k for _, k in self._entries})

    def entries(self) -> List[CostEntry]:
        with self._lock:
            return [CostEntry(**asdict(e)) for e in self._entries.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            return {
                "schema": STORE_SCHEMA,
                "alpha": self.alpha,
                "entries": [asdict(e) for e in
                            sorted(self._entries.values(),
                                   key=lambda e: (e.unit, e.kernel))],
            }

    def save(self, path: Optional[str] = None) -> str:
        """Write the store atomically (tmp + rename); returns the path."""
        target = os.fspath(path) if path is not None else self.path
        if target is None:
            raise ValueError("no path: pass save(path) or CostModel(path=...)")
        tmp = f"{target}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, target)
        return target

    def _load(self, path: str) -> None:
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict) or doc.get("schema") != STORE_SCHEMA:
                raise ValueError(
                    f"schema {doc.get('schema')!r} != {STORE_SCHEMA!r}"
                    if isinstance(doc, dict) else "store is not a JSON object"
                )
            entries = {}
            for raw in doc.get("entries", []):
                entry = CostEntry(**raw)
                entries[(entry.unit, entry.kernel)] = entry
        except Exception as exc:
            # Exception, not BaseException: a Ctrl-C or SystemExit during
            # load must propagate, not be swallowed into a cold start.
            warnings.warn(
                f"cost store {path!r} unusable ({exc}); cold-starting — "
                "learned splits fall back to adaptive until re-observed",
                CostModelWarning,
                stacklevel=3,
            )
            return
        with self._lock:
            self._entries = entries

    def describe(self) -> str:
        with self._lock:
            return (f"CostModel({len(self._entries)} entries, "
                    f"alpha={self.alpha}, path={self.path!r})")

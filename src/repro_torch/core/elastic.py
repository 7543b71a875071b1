"""Elastic scaling: unit join/leave, node-failure handling, mesh rebuild.

The paper reprograms the FPGA with different accelerator counts and the
scheduler just keeps working with whatever units exist.  This module
carries that property across two granularities:

* **Unit level** (:class:`ElasticEvent`, :class:`ElasticSchedule`) — a
  timeline of compute units joining or leaving *mid-run*.
  :meth:`~repro.core.runtime.HeteroRuntime.parallel_for` consumes a
  schedule under :class:`~repro.core.runtime.SimulatedClock`: when a
  unit leaves, its in-flight chunk is requeued and re-issued to a
  surviving unit (exact-once coverage is an invariant the tests pin);
  when a unit joins, it starts stealing chunks immediately, exactly as a
  freshly programmed FPGA block enters the paper's loop.  Every event is
  recorded in the run's :class:`~repro.core.interrupts.RunReport`.
* **Mesh level** (:class:`ElasticMeshManager`, :class:`RescalePlan`) —
  the pod-scale analogue: when a host (8 chips) or a whole slice dies
  mid-run, the job must (1) detect it, (2) compute the largest
  still-coherent mesh from surviving hardware, (3) re-shard the latest
  checkpoint onto the new mesh, and (4) resume — rather than sitting in
  a barrier forever.

The two meet in :meth:`ElasticSchedule.from_mesh`: bind runtime units to
the mesh's failure domains (hosts) and a fault timeline, and device
failures tracked by the mesh manager become unit-leave events for the
scheduler — the registry hook the ROADMAP names.

This module is deliberately runtime-agnostic: it reasons over abstract
device inventories so it is unit-testable on CPU, and `launch/train.py`
wires it to real failure signals (heartbeat timeouts / NCCL-style error
callbacks in a real deployment; simulated fault injection in tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "DeviceHealth",
    "RescalePlan",
    "ElasticMeshManager",
    "ElasticEvent",
    "ElasticSchedule",
]


@dataclass(frozen=True)
class ElasticEvent:
    """One unit joining or leaving the run at virtual time ``t``.

    ``t`` is *run-relative*: seconds of virtual time after the run's
    first dispatch, so the same schedule replays identically on a
    runtime whose clock has already advanced through earlier runs.
    ``kind``/``speed`` describe the joining unit (same semantics as
    :class:`~repro.core.runtime.UnitSpec`); both are ignored for leaves.
    """

    t: float
    action: str                    # "join" | "leave"
    unit: str
    kind: str = "cc"
    speed: Optional[float] = None

    def __post_init__(self) -> None:
        if self.action not in ("join", "leave"):
            raise ValueError(f"action must be join|leave, got {self.action!r}")
        if self.t < 0:
            raise ValueError(f"event time must be >= 0, got {self.t}")


class ElasticSchedule:
    """An ordered timeline of :class:`ElasticEvent`s for one run.

    Build directly::

        sched = ElasticSchedule()
        sched.leave(0.5, "cc0")
        sched.join(0.8, "cc9", kind="cc", speed=2e3)

    or derive unit events from mesh-level failures via :meth:`from_mesh`.
    """

    def __init__(self, events: Sequence[ElasticEvent] = ()) -> None:
        self._events: List[ElasticEvent] = list(events)

    def leave(self, t: float, unit: str) -> "ElasticSchedule":
        self._events.append(ElasticEvent(t=t, action="leave", unit=unit))
        return self

    def join(
        self, t: float, unit: str, *, kind: str = "cc", speed: Optional[float] = None
    ) -> "ElasticSchedule":
        self._events.append(
            ElasticEvent(t=t, action="join", unit=unit, kind=kind, speed=speed)
        )
        return self

    @property
    def events(self) -> List[ElasticEvent]:
        """Events in time order (stable for ties: insertion order)."""
        return sorted(self._events, key=lambda e: e.t)

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self.events)

    def merge(self, other: "ElasticSchedule") -> "ElasticSchedule":
        """A new schedule holding both timelines (time-sorted on read).

        The fleet layer composes membership from independent sources —
        a failure trace's crashes/leaves and an autoscaler's joins — and
        each source builds its own schedule; ``merge`` is how they become
        one run timeline without either source knowing about the other.
        """
        return ElasticSchedule(self._events + list(other._events))

    @classmethod
    def from_mesh(
        cls,
        manager: "ElasticMeshManager",
        bindings: Mapping[str, int],
        faults: Sequence[Tuple[float, int]],
        joins: Sequence[ElasticEvent] = (),
    ) -> "ElasticSchedule":
        """Unit-leave events from mesh failure domains.

        ``bindings`` maps unit name -> host id; ``faults`` is a timeline
        of ``(t, device_id)`` failures applied to ``manager`` (so its
        health book and any later :meth:`ElasticMeshManager.plan` stay
        consistent with the run).  A device failure takes out its whole
        host, so every unit bound to that host leaves at the fault time.
        ``joins`` are appended verbatim — replacement capacity admitted
        by the operator.
        """
        sched = cls()
        departed: set = set()
        for t, device_id in sorted(faults):
            before = set(manager.lost_ids)
            manager.mark_failed(device_id)
            lost_hosts = {
                manager.host_of(d) for d in manager.lost_ids if d not in before
            }
            for unit, host in bindings.items():
                if host in lost_hosts and unit not in departed:
                    departed.add(unit)
                    sched.leave(t, unit)
        for ev in joins:
            sched._events.append(ev)
        return sched


@dataclass
class DeviceHealth:
    device_id: int
    host_id: int
    healthy: bool = True
    consecutive_misses: int = 0


@dataclass(frozen=True)
class RescalePlan:
    """What to do after a failure: the new mesh and bookkeeping deltas."""

    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    healthy_devices: Tuple[int, ...]
    lost_devices: Tuple[int, ...]
    # data-parallel degree changed ⇒ global batch / accumulation must adapt
    dp_scale: float
    needs_reshard: bool

    @property
    def new_device_count(self) -> int:
        return int(math.prod(self.new_shape))


class ElasticMeshManager:
    """Tracks device health and produces :class:`RescalePlan`s.

    Mesh policy: the model axis is sacred (TP degree is baked into layouts
    and kernel block shapes), so failures are absorbed by shrinking the
    data/pod axes to the largest size that the surviving-device count
    supports with the model axis intact.  This matches production practice:
    you lose DP replicas, never TP shards.
    """

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Sequence[str],
        *,
        model_axis: str = "model",
        miss_threshold: int = 3,
        host_size: int = 8,
    ) -> None:
        if len(shape) != len(axis_names):
            raise ValueError("shape/axis_names length mismatch")
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.model_axis = model_axis
        self.miss_threshold = miss_threshold
        self.host_size = host_size
        n = math.prod(self.shape)
        self._devices: Dict[int, DeviceHealth] = {
            i: DeviceHealth(device_id=i, host_id=i // host_size) for i in range(n)
        }

    # -- health feed -------------------------------------------------------
    def heartbeat(self, device_id: int) -> None:
        d = self._devices[device_id]
        d.consecutive_misses = 0
        d.healthy = True

    def miss(self, device_id: int) -> None:
        d = self._devices[device_id]
        d.consecutive_misses += 1
        if d.consecutive_misses >= self.miss_threshold:
            self.mark_failed(device_id)

    def mark_failed(self, device_id: int) -> None:
        """A chip failure takes out its host (standard TPU failure domain)."""
        host = self._devices[device_id].host_id
        for d in self._devices.values():
            if d.host_id == host:
                d.healthy = False

    def host_of(self, device_id: int) -> int:
        return self._devices[device_id].host_id

    @property
    def healthy_ids(self) -> List[int]:
        return sorted(d.device_id for d in self._devices.values() if d.healthy)

    @property
    def lost_ids(self) -> List[int]:
        return sorted(d.device_id for d in self._devices.values() if not d.healthy)

    # -- planning ------------------------------------------------------------
    def plan(self) -> Optional[RescalePlan]:
        """None if the current mesh is intact; otherwise the rescale plan."""
        healthy = self.healthy_ids
        total = math.prod(self.shape)
        if len(healthy) == total:
            return None
        model_idx = self.axis_names.index(self.model_axis)
        model_deg = self.shape[model_idx]
        if len(healthy) < model_deg:
            raise RuntimeError(
                f"only {len(healthy)} healthy devices < model degree {model_deg}; "
                "job cannot continue"
            )
        usable_groups = len(healthy) // model_deg
        # Distribute surviving DP capacity over the non-model axes, shrinking
        # the outermost (pod) axis first — whole-slice failures are the norm.
        non_model = [
            (i, s) for i, s in enumerate(self.shape) if i != model_idx
        ]
        new_shape = list(self.shape)
        remaining = usable_groups
        # greedy: keep inner axes as large as possible
        for i, s in non_model:  # outermost first
            inner = math.prod(ns for j, ns in non_model if j > i)
            new_shape[i] = max(1, min(s, remaining // max(inner, 1)))
        # fix rounding: recompute inner-most axis to fit exactly
        def dp_degree(shape: List[int]) -> int:
            return math.prod(s for i, s in enumerate(shape) if i != model_idx)

        while dp_degree(new_shape) > usable_groups:
            for i, _ in non_model:
                if new_shape[i] > 1:
                    new_shape[i] -= 1
                    break
        old_dp = math.prod(s for i, s in enumerate(self.shape) if i != model_idx)
        plan = RescalePlan(
            old_shape=self.shape,
            new_shape=tuple(new_shape),
            axis_names=self.axis_names,
            healthy_devices=tuple(healthy[: math.prod(new_shape)]),
            lost_devices=tuple(self.lost_ids),
            dp_scale=dp_degree(new_shape) / old_dp,
            needs_reshard=True,
        )
        return plan

    def apply(self, plan: RescalePlan) -> None:
        """Adopt the new mesh shape (after checkpoint re-shard completed)."""
        self.shape = plan.new_shape
        keep = set(plan.healthy_devices)
        self._devices = {
            i: d for i, d in self._devices.items() if i in keep
        }

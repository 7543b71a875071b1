"""ENEAC core for the PyTorch port: the scheduling modules of ``repro.core``.

These are copies of the reference package's host-side modules, so that the
port imports nothing of ``repro``.  The one new piece is
:class:`~repro_torch.core.backends.CudaStreamUnit`, which takes the place
of the reference's jax device unit.

* :mod:`repro_torch.core.scheduler` — MultiDynamic heterogeneous chunk scheduler.
* :mod:`repro_torch.core.interrupts` — completion-driven async engine + busy-wait baseline.
* :mod:`repro_torch.core.backends` — backend units (threads, process pools,
  CUDA streams) + the event-driven wall-clock engine.
* :mod:`repro_torch.core.transport` — message-level transports (loopback,
  TCP, fault-injecting) and remote workers: ``RemoteWorker`` hosts backend
  units (``cuda`` included) behind a transport, ``RemoteUnit`` proxies them
  into the runtime as ordinary units, ``spawn_worker`` starts a worker
  process.
* :mod:`repro_torch.core.hetero` — throughput-proportional work partitioning.
* :mod:`repro_torch.core.costmodel` — online per-(unit, kernel) cost model.
* :mod:`repro_torch.core.straggler` — straggler detection and mitigation.
* :mod:`repro_torch.core.elastic` — node-failure handling / mesh rescale plans.
* :mod:`repro_torch.core.fleet` — fleet membership: heartbeat liveness ledger,
  queue-driven autoscaling, seeded churn simulation, and the wall-clock
  manager that owns ``spawn_worker`` subprocesses.
* :mod:`repro_torch.core.parallel_for` — hybrid dense/sparse executor (SPMM).
* :mod:`repro_torch.core.space` — flat, tiled and host-sharded iteration spaces.
* :mod:`repro_torch.core.runtime` — :class:`HeteroRuntime`, the front door.
"""

from .scheduler import Chunk, MultiDynamicScheduler, OracleStaticScheduler, StaticScheduler, WorkerKind
from .interrupts import AsyncEngine, CompletionEvent, PollingEngine, RunReport
from .backends import (
    BackendEngine,
    BackendUnit,
    CompletionBus,
    CompletionRecord,
    CudaStreamUnit,
    InlineUnit,
    ProcessPoolUnit,
    ThreadUnit,
    WorkerDead,
    WorkerLost,
)
from .transport import (
    FlakyTransport,
    LoopbackTransport,
    RemoteUnit,
    RemoteWorker,
    SocketTransport,
    Transport,
    TransportClosed,
    TransportError,
    WorkerHandle,
    WorkerServer,
    spawn_worker,
)
from .space import FlatSpace, IterationSpace, ShardedSpace, TiledSpace
from .costmodel import CostEntry, CostModel, CostModelWarning
from .runtime import HeteroRuntime, SimulatedClock, UnitSpec, WallClock, WorkQueue
from .hetero import HeteroPartition, HeterogeneousPartitioner, ThroughputTracker
from .straggler import MitigationPlan, StragglerDetector, StragglerMitigator, StragglerReport
from .elastic import DeviceHealth, ElasticEvent, ElasticMeshManager, ElasticSchedule, RescalePlan
from .parallel_for import HybridExecutor, SplitDecision
from .fleet import (
    Autoscaler,
    FailureTrace,
    FleetManager,
    FleetSimResult,
    HeartbeatBook,
    TraceEvent,
    simulate_fleet,
)

__all__ = [
    "HeteroRuntime",
    "SimulatedClock",
    "UnitSpec",
    "WallClock",
    "WorkQueue",
    "IterationSpace",
    "FlatSpace",
    "TiledSpace",
    "ShardedSpace",
    "ElasticEvent",
    "ElasticSchedule",
    "Chunk",
    "MultiDynamicScheduler",
    "StaticScheduler",
    "OracleStaticScheduler",
    "WorkerKind",
    "AsyncEngine",
    "PollingEngine",
    "CompletionEvent",
    "RunReport",
    "BackendEngine",
    "BackendUnit",
    "CompletionBus",
    "CompletionRecord",
    "InlineUnit",
    "ThreadUnit",
    "ProcessPoolUnit",
    "CudaStreamUnit",
    "WorkerLost",
    "WorkerDead",
    "Transport",
    "TransportError",
    "TransportClosed",
    "LoopbackTransport",
    "SocketTransport",
    "FlakyTransport",
    "RemoteUnit",
    "RemoteWorker",
    "WorkerServer",
    "WorkerHandle",
    "spawn_worker",
    "HeteroPartition",
    "HeterogeneousPartitioner",
    "ThroughputTracker",
    "CostModel",
    "CostEntry",
    "CostModelWarning",
    "StragglerDetector",
    "StragglerMitigator",
    "StragglerReport",
    "MitigationPlan",
    "DeviceHealth",
    "ElasticMeshManager",
    "RescalePlan",
    "HybridExecutor",
    "SplitDecision",
    "HeartbeatBook",
    "Autoscaler",
    "FailureTrace",
    "TraceEvent",
    "FleetSimResult",
    "FleetManager",
    "simulate_fleet",
]

"""Fault-tolerant checkpointing: async save, integrity-verified restore,
and coverage bitmaps that let a dead run resume from its last checkpoint
instead of recomputing.

The port's copy of ``repro.checkpoint`` without ``elastic_restore``
(mesh-changing restore, ROADMAP.md queue 1 slice F).
"""

from .checkpointer import Checkpointer, CheckpointInfo
from .coverage import (
    CheckpointedRun,
    CoverageMap,
    checkpointed_parallel_for,
    load_coverage,
    save_coverage,
)

__all__ = [
    "Checkpointer",
    "CheckpointInfo",
    "CoverageMap",
    "CheckpointedRun",
    "checkpointed_parallel_for",
    "save_coverage",
    "load_coverage",
]

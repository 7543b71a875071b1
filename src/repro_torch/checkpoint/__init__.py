"""Fault-tolerant checkpointing: async save, integrity-verified restore,
elastic (mesh-changing) restore, and coverage bitmaps that let a dead
run resume from its last checkpoint instead of recomputing.

The port's copy of ``repro.checkpoint``.
"""

from .checkpointer import Checkpointer, CheckpointInfo
from .coverage import (
    CheckpointedRun,
    CoverageMap,
    checkpointed_parallel_for,
    load_coverage,
    save_coverage,
)
from .elastic_restore import elastic_restore_summary, reshard_tree

__all__ = [
    "Checkpointer",
    "CheckpointInfo",
    "reshard_tree",
    "elastic_restore_summary",
    "CoverageMap",
    "CheckpointedRun",
    "checkpointed_parallel_for",
    "save_coverage",
    "load_coverage",
]

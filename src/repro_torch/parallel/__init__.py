"""Distribution layer: mesh rules, collectives, pipeline parallelism.

The port's copy of ``repro.parallel`` for slice F1: the rules and the
collectives that data parallelism with sharded weights runs on, the
compressed psum and the GPipe schedule.  ``repro.parallel.compat`` (a
``shard_map`` shim across JAX versions) has no counterpart.
"""

from .collectives import Group, compressed_psum, compressed_psum_tree
from .mesh_rules import (MeshRules, MeshShape, current_rules, hints_disabled, shard_hint,
                         use_rules)
from .pipeline import pipeline_apply, stage_partition

__all__ = [
    "MeshRules",
    "MeshShape",
    "use_rules",
    "current_rules",
    "hints_disabled",
    "shard_hint",
    "Group",
    "pipeline_apply",
    "stage_partition",
    "compressed_psum",
    "compressed_psum_tree",
]

"""Distribution layer: mesh rules, collectives, pipeline parallelism.

The port's copy of ``repro.parallel``: the rules and the collectives that
data parallelism with sharded weights runs on, the compressed psum and the
GPipe schedule (slice F1), and the collectives that carry gradients with
what the models ask of a model axis larger than 1 (:class:`TensorParallel`,
slice F2).  ``repro.parallel.compat`` (a ``shard_map`` shim across JAX
versions) has no counterpart.
"""

from .collectives import (Group, compressed_psum, compressed_psum_tree, copy_to, gather_seq,
                          pmean, reduce_from, scatter_seq)
from .mesh_rules import (MeshRules, MeshShape, current_rules, hints_disabled, shard_hint,
                         use_rules)
from .pipeline import pipeline_apply, stage_partition
from .tensor_parallel import TensorParallel

__all__ = [
    "MeshRules",
    "MeshShape",
    "use_rules",
    "current_rules",
    "hints_disabled",
    "shard_hint",
    "Group",
    "TensorParallel",
    "copy_to",
    "reduce_from",
    "gather_seq",
    "scatter_seq",
    "pmean",
    "pipeline_apply",
    "stage_partition",
    "compressed_psum",
    "compressed_psum_tree",
]

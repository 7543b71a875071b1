"""Data pipeline: deterministic sharded sources + async prefetch.

The port's own copy of ``repro.data`` (which imports only numpy; the port
imports nothing of ``repro``): the same batches, bit for bit, from the
same (step, shard, num_shards, per_shard).
"""

from .prefetch import Prefetcher
from .tokens import Batch, MemmapTokens, SyntheticTokens

__all__ = ["Batch", "SyntheticTokens", "MemmapTokens", "Prefetcher"]

"""Iteration spaces: what ``parallel_for`` iterates over.

ENEAC's scheduler operates on an abstract iteration space — the paper
runs it over HOTSPOT grid rows and SPMM sparse rows alike, because the
MultiDynamic loop only needs "hand me the next contiguous chunk of
indices".  This module makes that space a first-class object so the same
scheduler/engine machinery covers three shapes of work:

* :class:`FlatSpace` — the classic ``[0, N)`` range (rows, microbatches,
  request slots).  ``parallel_for(num_items=N)`` is sugar for it.
* :class:`TiledSpace` — a 2D element grid decomposed into tiles, for
  Pallas-kernel workloads (hotspot stencils, block-ELL SPMM): the
  scheduler sees a flat tile index, the work function decodes it back to
  ``(row_slice, col_slice)`` element coordinates via :meth:`TiledSpace.
  tile_slices`.  Tile shape is the accelerator's native block (e.g. the
  MXU's (8, 128)), so an ACC chunk is a run of whole hardware tiles.
* :class:`ShardedSpace` — a global space partitioned across host shards.
  Each shard runs its *own* scheduler + engine over its contiguous slice
  (the multi-device extension of the paper's single-SoC loop, after
  arXiv:1802.03316), and the runtime merges the per-shard
  :class:`~repro.core.interrupts.RunReport`s into one global report with
  per-shard coverage and cross-shard load balance.

Spaces are pure host-side index arithmetic — no jax, no threads — so
they compose with every policy, engine, and clock.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .scheduler import Chunk

__all__ = ["IterationSpace", "FlatSpace", "TiledSpace", "ShardedSpace", "as_space"]


class IterationSpace:
    """Base: a finite, contiguously indexable space ``[0, num_items)``.

    Subclasses only add *interpretation* (what an index means) and
    *partitioning* (how the space splits across shards); chunking within
    a shard always stays with the scheduler.
    """

    num_items: int

    def __len__(self) -> int:
        return self.num_items

    def describe(self) -> str:
        return f"{type(self).__name__}({self.num_items})"


class FlatSpace(IterationSpace):
    """The paper's original ``[0, N)`` iteration space."""

    def __init__(self, num_items: int) -> None:
        if num_items <= 0:
            raise ValueError(f"num_items must be positive, got {num_items}")
        self.num_items = int(num_items)


class TiledSpace(IterationSpace):
    """A 2D element grid decomposed into scheduler-visible tiles.

    ``grid=(R, C)`` are element dimensions, ``tile=(tr, tc)`` the tile
    shape; the space has ``ceil(R/tr) * ceil(C/tc)`` items, one per tile,
    laid out row-major so a contiguous chunk is a run of tiles sweeping
    columns fastest (the cache/HBM-friendly order for stencils and
    block-ELL rows alike).  Edge tiles are clipped to the grid.
    """

    def __init__(self, grid: Tuple[int, int], tile: Tuple[int, int]) -> None:
        if len(grid) != 2 or len(tile) != 2:
            raise ValueError(f"grid/tile must be 2D, got {grid} / {tile}")
        if min(grid) <= 0 or min(tile) <= 0:
            raise ValueError(f"grid/tile entries must be positive: {grid} / {tile}")
        self.grid = (int(grid[0]), int(grid[1]))
        self.tile = (int(tile[0]), int(tile[1]))
        self.tiles = (
            math.ceil(self.grid[0] / self.tile[0]),
            math.ceil(self.grid[1] / self.tile[1]),
        )
        self.num_items = self.tiles[0] * self.tiles[1]

    def tile_index(self, i: int) -> Tuple[int, int]:
        """Flat item index -> (tile_row, tile_col)."""
        if not 0 <= i < self.num_items:
            raise IndexError(f"tile {i} outside [0, {self.num_items})")
        return divmod(i, self.tiles[1])

    def tile_slices(self, i: int) -> Tuple[slice, slice]:
        """Flat item index -> element ``(row_slice, col_slice)``, edge-clipped."""
        ti, tj = self.tile_index(i)
        r0, c0 = ti * self.tile[0], tj * self.tile[1]
        return (
            slice(r0, min(r0 + self.tile[0], self.grid[0])),
            slice(c0, min(c0 + self.tile[1], self.grid[1])),
        )

    def chunk_slices(self, chunk: Chunk) -> List[Tuple[slice, slice]]:
        """All element slices covered by a scheduler chunk, in issue order."""
        return [self.tile_slices(i) for i in chunk.indices()]

    def describe(self) -> str:
        return (
            f"TiledSpace(grid={self.grid}, tile={self.tile}, "
            f"tiles={self.tiles[0]}x{self.tiles[1]})"
        )


class ShardedSpace(IterationSpace):
    """A global space split into contiguous per-host shards.

    Each shard is scheduled *independently* — its own tracked scheduler
    and engine over ``[start_k, stop_k)``, with the full unit set
    replicated per shard (one host's worth of ACC+CC units each) — and
    the runtime's merge step reassembles a global report.  ``weights``
    skews the partition for known-heterogeneous hosts (items proportional
    to weight, largest-remainder rounding, every shard non-empty while
    items allow).

    The inner space may itself be a :class:`TiledSpace`, in which case
    shard slices are runs of tiles.

    ``placement`` pins compute units to shards: a ``{unit_name: shard}``
    mapping consumed by the runtime when it builds per-shard schedulers.
    Unpinned units are replicated onto every shard (the PR 3 default);
    pinned units are scheduled *only* by their shard's engine — required
    for real backend units (a device stream belongs to one host) and for
    remote units (``backend="remote:<host:port>"``: the worker behind
    the transport *is* a host, so exactly one shard engine may drive
    it), the shard-aware placement hook the ROADMAP names.
    """

    def __init__(
        self,
        inner: Union[int, IterationSpace],
        num_shards: int,
        *,
        weights: Sequence[float] = (),
        placement: Optional[Mapping[str, int]] = None,
    ) -> None:
        if isinstance(inner, ShardedSpace):
            raise TypeError("ShardedSpace cannot nest another ShardedSpace")
        self.inner: IterationSpace = (
            FlatSpace(inner) if isinstance(inner, int) else inner
        )
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        if num_shards > self.inner.num_items:
            raise ValueError(
                f"{num_shards} shards for {self.inner.num_items} items: "
                "some shards would be empty"
            )
        self.num_shards = int(num_shards)
        self.num_items = self.inner.num_items
        if weights:
            if len(weights) != num_shards:
                raise ValueError(
                    f"{len(weights)} weights for {num_shards} shards"
                )
            if min(weights) <= 0:
                raise ValueError(f"weights must be positive: {list(weights)}")
            self.weights = tuple(float(w) for w in weights)
        else:
            self.weights = tuple(1.0 for _ in range(num_shards))
        if placement:
            bad = {u: k for u, k in placement.items()
                   if not 0 <= int(k) < num_shards}
            if bad:
                raise ValueError(
                    f"placement maps units to nonexistent shards: {bad} "
                    f"(have {num_shards} shards)"
                )
            self.placement: Optional[Dict[str, int]] = {
                str(u): int(k) for u, k in placement.items()
            }
        else:
            self.placement = None
        self._bounds = self._partition()

    def _partition(self) -> List[Tuple[int, int]]:
        n, total = self.num_items, sum(self.weights)
        # largest-remainder apportionment with a floor of 1 item per shard
        raw = [n * w / total for w in self.weights]
        counts = [max(1, int(r)) for r in raw]
        while sum(counts) > n:
            counts[counts.index(max(counts))] -= 1
        remainders = sorted(
            range(self.num_shards), key=lambda k: raw[k] - int(raw[k]), reverse=True
        )
        k = 0
        while sum(counts) < n:
            counts[remainders[k % self.num_shards]] += 1
            k += 1
        bounds, start = [], 0
        for c in counts:
            bounds.append((start, start + c))
            start += c
        assert start == n, (bounds, n)
        return bounds

    def shard_bounds(self, k: int) -> Tuple[int, int]:
        """Global ``(start, stop)`` of shard ``k``."""
        return self._bounds[k]

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        return list(self._bounds)

    def shard_of(self, i: int) -> int:
        """Which shard owns global index ``i``."""
        for k, (a, b) in enumerate(self._bounds):
            if a <= i < b:
                return k
        raise IndexError(f"index {i} outside [0, {self.num_items})")

    def describe(self) -> str:
        return (
            f"ShardedSpace({self.inner.describe()}, num_shards={self.num_shards})"
        )


def as_space(space_or_n: Union[int, IterationSpace, None], num_items: int) -> IterationSpace:
    """Normalize ``parallel_for``'s (space, num_items) pair to a space."""
    if space_or_n is None:
        return FlatSpace(num_items)
    if isinstance(space_or_n, int):
        return FlatSpace(space_or_n)
    if isinstance(space_or_n, IterationSpace):
        if num_items and num_items != space_or_n.num_items:
            raise ValueError(
                f"num_items={num_items} contradicts {space_or_n.describe()}"
            )
        return space_or_n
    raise TypeError(f"not an IterationSpace: {space_or_n!r}")

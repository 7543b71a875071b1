"""Checkpoint-backed coverage: resume a parallel_for after fleet death.

The port's copy of ``repro.checkpoint.coverage``; its checkpoints are the
reference's, so a bitmap saved by either package resumes in the other.

The transport/engine layers already survive *one worker* dying mid-run
(exact-once requeue to survivors).  This module covers the failure mode
above that: the whole run dies — driver crash, job preemption, every
worker gone — and a restart should pay only for the items that were
never finished, not recompute the full pre-split.

The checkpoint payload is deliberately a **fixed-shape done-bitmap**
(one ``bool`` per item of the original space), not a list of remaining
spans: :meth:`repro_torch.checkpoint.Checkpointer.restore` verifies shapes
against a ``like_tree``, and a bitmap of ``num_items`` bools has the
same shape at every step no matter how coverage is distributed — so the
existing integrity-verified restore path works unmodified.

:func:`checkpointed_parallel_for` runs the space in *rounds*: take the
next slab of not-yet-done items, run one ``parallel_for`` over a
compact space remapped onto those global items, mark the bitmap, save
it asynchronously, repeat.  Within a round, worker loss is the engine's
exact-once problem; across process death, the latest bitmap bounds the
recompute to at most one round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.scheduler import Chunk
from .checkpointer import Checkpointer

__all__ = [
    "CheckpointedRun",
    "CoverageMap",
    "checkpointed_parallel_for",
    "load_coverage",
    "save_coverage",
]

_TREE_KEY = "coverage_done"


class CoverageMap:
    """A done-bitmap over a flat item space ``[0, num_items)``."""

    def __init__(self, num_items: int,
                 done: Optional[np.ndarray] = None) -> None:
        if num_items <= 0:
            raise ValueError(f"num_items must be positive, got {num_items}")
        if done is None:
            done = np.zeros(num_items, dtype=bool)
        else:
            done = np.asarray(done, dtype=bool)
            if done.shape != (num_items,):
                raise ValueError(
                    f"done bitmap has shape {done.shape}, "
                    f"want ({num_items},)"
                )
            done = done.copy()
        self.num_items = int(num_items)
        self.done = done

    def mark(self, start: int, stop: int) -> None:
        if not (0 <= start <= stop <= self.num_items):
            raise ValueError(
                f"span [{start}, {stop}) outside [0, {self.num_items})"
            )
        self.done[start:stop] = True

    def mark_ids(self, ids: np.ndarray) -> None:
        self.done[np.asarray(ids, dtype=np.int64)] = True

    @property
    def items_done(self) -> int:
        return int(self.done.sum())

    @property
    def complete(self) -> bool:
        return bool(self.done.all())

    def remaining_ids(self) -> np.ndarray:
        """Global indices still uncovered, ascending."""
        return np.flatnonzero(~self.done)

    def remaining_spans(self) -> List[Tuple[int, int]]:
        """Uncovered items as maximal contiguous ``(start, stop)`` spans."""
        ids = self.remaining_ids()
        if ids.size == 0:
            return []
        breaks = np.flatnonzero(np.diff(ids) > 1)
        starts = np.concatenate(([0], breaks + 1))
        stops = np.concatenate((breaks, [ids.size - 1]))
        return [(int(ids[a]), int(ids[b]) + 1)
                for a, b in zip(starts, stops)]

    def tree(self) -> dict:
        """The checkpoint payload (fixed shape at every step)."""
        return {_TREE_KEY: self.done.copy()}


def save_coverage(ckpt: Checkpointer, step: int, cov: CoverageMap,
                  *, blocking: bool = False):
    """Async-save the bitmap through the standard checkpointer (tmp +
    atomic rename + manifest hashes); returns the completion event."""
    return ckpt.save(step, cov.tree(), blocking=blocking)


def load_coverage(ckpt: Checkpointer,
                  num_items: int) -> Optional[Tuple[CoverageMap, int]]:
    """The latest saved bitmap and its step, or None with no checkpoint.

    Restores through the verifying path against a fixed-shape
    ``like_tree``, so a bitmap saved for a *different* space size fails
    loudly instead of silently resuming the wrong run.
    """
    step = ckpt.latest_step()
    if step is None:
        return None
    like = CoverageMap(num_items).tree()
    tree, got_step = ckpt.restore(step, like)
    return CoverageMap(num_items, done=tree[_TREE_KEY]), int(got_step)


@dataclass
class CheckpointedRun:
    """What a :func:`checkpointed_parallel_for` call actually did."""

    num_items: int
    items_run: int          # items executed by THIS call (not restored ones)
    resumed_from_step: Optional[int]
    resumed_items_done: int  # items the restored bitmap already covered
    rounds: int
    last_step: int
    reports: List[object] = field(default_factory=list)  # per-round RunReport

    @property
    def resumed(self) -> bool:
        return self.resumed_from_step is not None


class _RemappedWork:
    """Compact-space chunk -> global-item spans -> the user's work_fn.

    A round's scheduler runs over ``[0, len(ids))``; this adapter turns
    each compact chunk into the (possibly several) contiguous global
    spans it covers and invokes the user's work function once per span,
    so user code only ever sees real item indices.
    """

    def __init__(self, work_fn: Callable, ids: np.ndarray) -> None:
        self.work_fn = work_fn
        self.ids = ids

    def __call__(self, chunk) -> None:
        gids = self.ids[chunk.start:chunk.stop]
        if gids.size == 0:
            return
        breaks = np.flatnonzero(np.diff(gids) > 1)
        starts = np.concatenate(([0], breaks + 1))
        stops = np.concatenate((breaks, [gids.size - 1]))
        for a, b in zip(starts, stops):
            self.work_fn(Chunk(start=int(gids[a]), stop=int(gids[b]) + 1,
                               worker=chunk.worker))


def checkpointed_parallel_for(
    runtime,
    work_fn: Callable,
    num_items: int,
    *,
    checkpointer: Checkpointer,
    round_items: Optional[int] = None,
    resume: bool = True,
    **parallel_for_kwargs,
) -> CheckpointedRun:
    """``parallel_for`` with coverage checkpointing between rounds.

    The space is processed in rounds of at most ``round_items``
    (default: one quarter of the remainder, min 1 — four checkpoints
    for a fresh run).  After each round the bitmap is saved
    asynchronously at ``step = items_done`` (monotone by construction,
    so ``latest_step`` is also "most covered").  With ``resume=True``
    (the default) a compatible existing checkpoint seeds the bitmap and
    only the remaining items run; ``resume=False`` starts from zero.

    Remaining keyword arguments pass straight to
    :meth:`~repro_torch.core.runtime.HeteroRuntime.parallel_for` (``policy``,
    ``acc_chunk``, ``engine``, ``backend`` ...).  ``item_cost`` under a
    SimulatedClock is remapped per round onto the surviving items.
    ``space``/``elastic`` are not supported here: rounds redefine the
    space, and a membership timeline's run-relative times would silently
    rebase every round.
    """
    for bad in ("space", "elastic", "num_items"):
        if bad in parallel_for_kwargs:
            raise ValueError(
                f"checkpointed_parallel_for does not accept {bad!r}"
            )
    item_cost = parallel_for_kwargs.pop("item_cost", None)
    if item_cost is not None and len(item_cost) != num_items:
        raise ValueError(
            f"item_cost has {len(item_cost)} entries for {num_items} items"
        )

    cov = CoverageMap(num_items)
    resumed_step: Optional[int] = None
    if resume:
        loaded = load_coverage(checkpointer, num_items)
        if loaded is not None:
            cov, resumed_step = loaded
    resumed_done = cov.items_done

    reports: List[object] = []
    items_run = 0
    rounds = 0
    last_step = resumed_step if resumed_step is not None else 0
    default_round = max((num_items - resumed_done + 3) // 4, 1)
    per_round = round_items if round_items is not None else default_round
    if per_round < 1:
        raise ValueError(f"round_items must be >= 1, got {per_round}")

    while not cov.complete:
        ids = cov.remaining_ids()[:per_round]
        kw = dict(parallel_for_kwargs)
        if item_cost is not None:
            kw["item_cost"] = [float(item_cost[int(g)]) for g in ids]
        report = runtime.parallel_for(
            _RemappedWork(work_fn, ids),
            num_items=int(ids.size),
            **kw,
        )
        cov.mark_ids(ids)
        items_run += int(ids.size)
        rounds += 1
        last_step = cov.items_done
        save_coverage(checkpointer, last_step, cov)
        reports.append(report)
    checkpointer.wait_all()

    return CheckpointedRun(
        num_items=num_items,
        items_run=items_run,
        resumed_from_step=resumed_step,
        resumed_items_done=resumed_done,
        rounds=rounds,
        last_step=last_step,
        reports=reports,
    )

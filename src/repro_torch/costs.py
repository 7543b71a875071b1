"""The active cost report: where meta routes and shape-only groups charge.

The dry-run (``launch/dryrun.py``) runs one rank's step on ``meta``
tensors under an op report (``launch/op_analysis.py``) made active here
by :func:`pricing`.  Two kinds of code charge it without computing
anything:

* a kernel wrapper handed ``meta`` tensors (K4, K5) launches nothing and
  counts no launch: it checks the shapes and dtypes its CUDA route takes,
  returns ``meta`` outputs, and charges the kernel's own forward cost —
  its ``kernel_flops`` and ``kernel_hbm_bytes`` — with :func:`charge`;
* a :class:`~repro_torch.parallel.collectives.ShapeGroup` charges the
  bytes each of its collectives hands, by kind.

A report may run a stretch of the step as ``k`` copies of itself
(``scale``: a training step's identical microbatches); every charge made
inside counts ``k`` times.  With no report active nothing is charged.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

__all__ = ["pricing", "charge", "charge_collective", "scale"]

_ACTIVE: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "repro_torch_cost_report", default=None)


@contextlib.contextmanager
def pricing(report):
    """Make ``report`` (with ``charge_kernel``, ``charge_collective`` and
    ``scale``) the active one inside the block."""
    token = _ACTIVE.set(report)
    try:
        yield report
    finally:
        _ACTIVE.reset(token)


def scale() -> int:
    """How many times a charge made now counts (1 with no report)."""
    report = _ACTIVE.get()
    return 1 if report is None else report.scale


def charge(name: str, flops: float, hbm_bytes: float) -> None:
    """One meta call of kernel ``name``: its forward's operations and bytes."""
    report = _ACTIVE.get()
    if report is not None:
        report.charge_kernel(name, float(flops), float(hbm_bytes))


def charge_collective(group: str, kind: str, shape: Tuple[int, ...], dtype, nbytes: int) -> None:
    """One collective of a shape-only ``group``: ``nbytes`` handed (already
    scaled), of a tensor of ``shape`` and ``dtype``."""
    report = _ACTIVE.get()
    if report is not None:
        report.charge_collective(group, kind, shape, dtype, nbytes)

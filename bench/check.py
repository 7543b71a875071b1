"""The numbers that decide ``correct`` for a training cell.

Both sides start from the same weights and take the same first steps
(the program through its timed call, the reference in float32):

* ``loss_gap``: over those steps, the largest |program's loss −
  reference's| / |reference's|;
* ``grad_gap``: the first step's gradient as the optimizer gets it (the
  program's is worked out from its first moment after one step), by the
  worst leaf: |program's norm − reference's| / the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of the weights' change after the last of those
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (AdamW moves them by round-off alone).

Each has a limit, set in ``limits/<cell>.json`` from the readings of
sound runs, of the control and of the faults (``PERF.md`` gives them); a
run is correct when every number with a limit is at or under it.  A
number whose limit is ``null`` had no upper reading (neither the control
nor a fault separated it from sound runs): it is printed, not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

__all__ = ["NAMES", "numbers", "worst_leaf", "kept", "verdict"]

NAMES = ("loss_gap", "grad_gap", "change_gap")
NEGLIGIBLE = 1e-3


def worst_leaf(got: List[float], ref: List[float],
               keep: Optional[List[bool]] = None) -> Tuple[float, int]:
    """(the worst leaf's gap, its index)."""
    keep = keep or [True] * len(ref)
    median = statistics.median(r for r, k in zip(ref, keep) if k)
    return max((abs(g - r) / max(r, median, 1e-30), i)
               for i, (g, r, k) in enumerate(zip(got, ref, keep)) if k)


def kept(ref: Dict) -> List[bool]:
    """The leaves the change is compared on: reference gradient at least a
    thousandth of the median leaf's."""
    median = statistics.median(ref["raw_grads"])
    return [g >= NEGLIGIBLE * median for g in ref["raw_grads"]]


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{name: number} of the program's readings against the reference's."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(prog["grads"], ref["grads"])[0],
            "change_gap": worst_leaf(prog["changes"], ref["changes"], kept(ref))[0]}


def verdict(values: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number with a limit finite and at or under it."""
    return all(values[k] == values[k] and values[k] <= limits[k]
               for k in NAMES if limits[k] is not None)

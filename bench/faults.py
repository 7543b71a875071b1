"""Faults planted under the timed path, for the checks that ``correct``
must catch (``calibrate.py`` reads them on the chip; the tests on the CPU).

Each wraps a training step ``step(params, opt_state, batch)``:

* :func:`unchanged`: the step runs, and returns the weights it was given;
* :func:`half_batch`: the step takes the first half of the batch's rows
  only, its loss the mean over them.
"""

from __future__ import annotations

__all__ = ["unchanged", "half_batch", "FAULTS"]


def unchanged(step):
    def faulty(params, opt_state, batch):
        _, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics
    return faulty


def half_batch(step):
    def faulty(params, opt_state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(params, opt_state, {k: v[:rows] for k, v in batch.items()})
    return faulty


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}

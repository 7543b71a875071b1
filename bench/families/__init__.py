"""Model families, one file each: ``families/<family>.py``.

A configuration's ``model`` group names its family (``"family"``); the
benchmark finds everything that differs from family to family in that
file, so a new family joins by adding one.  Each file gives:

* ``TINY``: the sizes of the CPU tests' tiny cells (``tests/tiny.py``);
* ``param_spec(m)``: the family's layer entries in the parameter tree's
  order, each ``(path, shape)`` (a projection: normal, std 1/sqrt(fan
  in)) or ``(path, shape, init, scale)`` as
  ``reference.model.param_spec`` states them, paths whole
  (``("layers", i, …)``);
* ``layer(p, x, m, mm)``: one layer's float32 forward on rows x (b, S,
  d) through the product ``mm``, where the loss is a sum over rows: the
  reference then takes each microbatch in blocks of rows
  (``reference.model.blocked_loss``);
* or, where it is not (experts' capacity, terms averaged over a
  microbatch), ``microbatch_loss(tree, tokens, labels, m, t, mm,
  rows_per_block, count)``: the reference's forward and backward of one
  of the step's microbatches whole, with every term the program's loss
  adds: it calls ``.backward()`` on each part's loss over ``count`` (the
  step's tokens) and returns the float sum;
* ``matmul_weights(m)``: the weights of the family's layers that multiply
  one token's activations (the active ones: those a token is routed to);
* ``mixer_flops(m, rows, seq)``: the least forward work of the layers'
  attention or scan over ``rows`` × ``seq`` tokens (``flops.model_flops``
  adds 3 × it to 6 × the weights × the tokens);
* optionally ``PARALLEL``: the ``ParallelConfig`` fields that the
  reference follows, which a configuration may set (``harness.PARALLEL``).

The embedding, the final norm, the head, the loss over the vocabulary and
the weights' share of the FLOPs are shared (``reference/model.py``,
``flops.py``).  Family files import with absolute names (``bench.…``):
they are loaded by path.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType

__all__ = ["DIR", "load"]

DIR = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def _load(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"bench_family_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(family: str) -> ModuleType:
    """The module of ``families/<family>.py`` (in :data:`DIR`)."""
    path = DIR / f"{family}.py"
    if not path.is_file():
        raise LookupError(f"no file for the {family!r} family: add {path} (see "
                          "bench/families/__init__.py for what it gives)")
    return _load(path)

"""Spans over the parts of a training step, on the profiler's clock.

While spans are on (:func:`enable`), :func:`span` marks a region of host
code as ``repro.<name>``: a ``torch.profiler.record_function`` range, so a
trace of ``torch.profiler`` holds it beside the device's kernels and any
other range, on one clock, and each device operation can be put down to
the innermost span open on the host when it was launched.  While spans
are off (the default) :func:`span` returns one shared no-op context and
nothing else runs.

A backward runs on autograd's own thread, in an order autograd chooses, so
its parts are marked by gradient hooks instead: :class:`BackwardChain`
opens ``repro.<name>`` when the gradient of a layer's output arrives and
closes it when its input's does.  The hooks are registered only while
spans are on, and leave every gradient as it is.

Spans sit at layer boundaries only (the step's backward, accumulation and
update; the loss; each block), never inside a loop over leaves or chunks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
from torch.profiler import record_function

__all__ = ["enable", "enabled", "span", "BackwardChain", "close_backward"]

PREFIX = "repro."

_on = False
_OFF = contextlib.nullcontext()
# spans opened by gradient hooks and not yet closed; hooks run on autograd's
# thread, close_backward on the caller's
_lock = threading.Lock()
_open: Dict[int, record_function] = {}


def enable(on: bool) -> None:
    """Turn spans on or off for the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that marks its body as ``repro.<name>`` while spans are on."""
    return record_function(PREFIX + name) if _on else _OFF


def _open_span(name: str) -> int:
    rf = record_function(PREFIX + name)
    rf.__enter__()
    with _lock:
        _open[id(rf)] = rf
    return id(rf)


def _close_span(key: Optional[int]) -> None:
    with _lock:
        rf = _open.pop(key, None)
    if rf is not None:
        rf.__exit__(None, None, None)


def close_backward() -> None:
    """Close every span a gradient hook opened and none closed: the caller
    of a backward calls it when the backward returns or raises."""
    with _lock:
        left = list(_open.values())
        _open.clear()
    for rf in reversed(left):
        rf.__exit__(None, None, None)


class BackwardChain:
    """Spans over the backward of a chain of layers, layer ``i`` taking
    the output of layer ``i - 1``: ``repro.<name>`` of a layer opens when
    the gradient of its output arrives and closes when its input's does.

    Call :meth:`layer` with each layer's input before the layer runs and
    :meth:`end` with the last output; a layer seen before (a checkpoint's
    recomputation) registers nothing again.  One hook a boundary: the
    tensor between two layers closes the later layer's span, then opens
    the earlier one's.  Make one only while spans are on."""

    def __init__(self) -> None:
        self._names: Dict[int, str] = {}
        self._keys: Dict[int, Optional[int]] = {}
        self._last: Optional[int] = None

    def _hook(self, tensor: torch.Tensor, close: Optional[int], open_: Optional[int]) -> None:
        def hook(grad):
            if close is not None:
                _close_span(self._keys.pop(close, None))
            if open_ is not None:
                self._keys[open_] = _open_span(self._names[open_])

        tensor.register_hook(hook)

    def layer(self, i: int, name: str, x: torch.Tensor) -> None:
        """Layer ``i``, named ``name``, is about to run on ``x``."""
        if i in self._names or not x.requires_grad:
            return
        self._names[i] = name
        self._hook(x, i, self._last)
        self._last = i

    def end(self, x: torch.Tensor) -> None:
        """``x`` is the last layer's output."""
        if self._last is not None and x.requires_grad:
            self._hook(x, None, self._last)
            self._last = None

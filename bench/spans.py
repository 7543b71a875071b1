"""The program's spans in a profiler trace of the traced window.

``repro_torch.tracing`` marks the parts of a training step as ``repro.*``
ranges while its spans are on: the loss, each block's forward, its re-run
under remat and its backward, the step's backward, the gradient sum and
the update.  :func:`read_spans` reads them beside :func:`trace.read_trace`'s
view: every ``repro.*`` range with its host thread, and each device
operation's innermost ``repro.*`` range, on any host thread, whose
interval holds the operation's launch.  The per-layer readers
``metrics/loss_ms.train.py``, ``accumulate_ms.train.py``,
``recompute_ms.train.py``, ``block_eager_ms.train.py`` and
``update_host_ms.train.py`` take their numbers from such a view, and read
``None`` from a view without spans.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from bench.trace import DEVICE_CATS, LAUNCH_CATS, DeviceOp, TraceView, read_trace

__all__ = ["Span", "SpanOp", "SpanView", "read_spans", "innermost_at", "idle_gaps_by_span",
           "is_rerun", "first_run"]

PREFIX = "repro."
BACKWARD = "repro.backward"
BLOCK = re.compile(r"^repro\.block\.\w+$")      # a block's forward, or its re-run


@dataclass(frozen=True)
class Span:
    name: str
    start: float          # µs, the trace's clock
    end: float
    thread: int           # the host thread that opened it


@dataclass
class SpanOp(DeviceOp):
    span: Optional[Span] = None     # the innermost program span open at its launch


@dataclass
class SpanView(TraceView):
    spans: List[Span] = field(default_factory=list)


def read_spans(path: str, steps: int, cell: Dict,
               counters: Optional[Dict[str, int]] = None) -> SpanView:
    """:func:`trace.read_trace`'s view of the trace at ``path``, its ops
    each with its span, and every ``repro.*`` range."""
    view = read_trace(path, steps, cell, counters)
    lo, hi = view.window
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        if cat == "user_annotation" and name.startswith(PREFIX):
            start = float(e["ts"])
            spans.append(Span(name, start, start + float(e.get("dur", 0)), int(e.get("tid", 0))))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS and lo <= float(e["ts"]) <= hi:   # read_trace's ops, in order
            device.append(e)
    spans.sort(key=lambda s: s.start)
    innermost = innermost_at(spans)
    if len(device) != len(view.ops):
        raise RuntimeError(f"{len(device)} device operations in the window, "
                           f"read_trace read {len(view.ops)}")
    ops = [SpanOp(op.name, op.start, op.dur, op.range,
                  innermost(launches.get(e.get("args", {}).get("correlation"))))
           for op, e in zip(view.ops, device)]
    return SpanView(ops, view.window, view.steps, view.cell, view.counters, spans)


def innermost_at(spans: List[Span]) -> Callable[[Optional[float]], Optional[Span]]:
    """A function of a time on the trace's clock (or ``None``) to the
    innermost of ``spans`` (ordered by start) open then, on any thread."""
    starts = [s.start for s in spans]

    def innermost(t: Optional[float]) -> Optional[Span]:
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:      # the latest-opened span still open at t
            if spans[i].end >= t:
                return spans[i]
            i -= 1
        return None

    return innermost


def is_rerun(view: SpanView, span: Span) -> bool:
    """Whether ``span`` is a block's re-run: a ``repro.block.<kind>`` range
    lying inside a ``repro.backward`` range."""
    return bool(BLOCK.match(span.name)) and any(
        b.name == BACKWARD and b.start <= span.start and span.end <= b.end for b in view.spans)


def first_run(view: SpanView, span: Span) -> bool:
    """Whether ``span`` is a block's first forward (outside every backward)."""
    return bool(BLOCK.match(span.name)) and not is_rerun(view, span)


def idle_gaps_by_span(view: SpanView, top: int = 10) -> List[List]:
    """``breakdown``'s longest idle gaps of the device, each labelled by
    the span of the op that ends it, or by that op's ``bench.*`` range
    where no program span was open (``bench.sync`` for the gap before the
    window's end)."""
    ordered = sorted(view.ops, key=lambda o: o.start)
    gaps, edge = [], view.window[0]
    for op in ordered:
        if op.start > edge:
            gaps.append([op.span.name if op.span is not None else op.range,
                         (op.start - edge) / 1e6])
        edge = max(edge, op.start + op.dur)
    if view.window[1] > edge:
        gaps.append(["bench.sync", (view.window[1] - edge) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]

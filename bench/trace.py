"""Reading a profiler trace of the traced window.

The harness records the window with ``torch.profiler`` (CPU and CUDA
activities), exports the Chrome trace into ``TMPDIR``, and reads it here
into a :class:`TraceView`: every device operation (kernel, copy, memset)
with its interval and the benchmark's host range (``bench.batch``,
``bench.grads``, ``bench.update``) its launch fell in, the traced window,
and the program's launch counters over it.  The per-layer readers
(``metrics/<name>.py``) take their numbers from the view.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["DeviceOp", "TraceView", "read_trace", "busy_intervals", "breakdown"]

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
RANGE_PREFIX = "bench."
WINDOW = "bench.window"


@dataclass
class DeviceOp:
    name: str
    start: float          # µs, the trace's clock
    dur: float            # µs
    range: str            # the benchmark's host range its launch fell in


@dataclass
class TraceView:
    ops: List[DeviceOp]
    window: Tuple[float, float]          # µs
    steps: int
    cell: Dict                           # {"model": …, "traffic": …}
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def matching(self, pattern: str) -> List[DeviceOp]:
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op.name)]

    def seconds(self, ops: List[DeviceOp]) -> float:
        return sum(op.dur for op in ops) / 1e6


def busy_intervals(ops: List[DeviceOp]) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, merged and in order."""
    merged: List[List[float]] = []
    for op in sorted(ops, key=lambda o: o.start):
        end = op.start + op.dur
        if merged and op.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([op.start, end])
    return [(a, b) for a, b in merged]


def _short(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
            break
    return name.strip()[:160]


def read_trace(path: str, steps: int, cell: Dict,
               counters: Optional[Dict[str, int]] = None) -> TraceView:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        if cat == "user_annotation" and name.startswith(RANGE_PREFIX):
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), name))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    window = [r for r in ranges if r[2] == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = window[0][0], window[0][1]
    inner = sorted((r for r in ranges if r[2] != WINDOW), key=lambda r: r[0])
    starts = [r[0] for r in inner]

    def range_at(t: Optional[float]) -> str:
        if t is None:
            return "unknown"
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            a, b, name = inner[i]
            if a <= t <= b:
                return name
            i -= 1
        return WINDOW if lo <= t <= hi else "outside"

    ops = []
    for e in device:
        start = float(e["ts"])
        if start < lo or start > hi:
            continue
        launched = launches.get(e.get("args", {}).get("correlation"))
        ops.append(DeviceOp(_short(str(e.get("name", ""))), start, float(e.get("dur", 0)),
                            range_at(launched)))
    return TraceView(ops, (lo, hi), steps, cell, dict(counters or {}))


def breakdown(view: TraceView, top: int = 10) -> Dict[str, List[List]]:
    """The device ops that took most time, and the longest idle gaps of
    the device labelled by the host range that launched the op ending
    each gap (``bench.sync`` for the gap before the window's end)."""
    by_name: Dict[str, float] = {}
    for op in view.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.dur / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ordered = sorted(view.ops, key=lambda o: o.start)
    gaps, edge = [], view.window[0]
    for op in ordered:
        if op.start > edge:
            gaps.append([op.range, (op.start - edge) / 1e6])
        edge = max(edge, op.start + op.dur)
    if view.window[1] > edge:
        gaps.append(["bench.sync", (view.window[1] - edge) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": gaps[:top]}

"""Op-level cost report of one step on ``meta`` tensors: the three roofline
numerators without a card.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
parses the compiled HLO; the port has none, so :func:`analyze_step` runs
the step once, eagerly, on ``meta`` tensors, and counts what each op
would do:

* **dot FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``'s count of
  every op it counts (matrix products, forward and backward: its
  ``flop_registry``, applied here so one dispatch mode does all the
  counting), plus each kernel's meta route (K4, K5): the forward priced by
  its ``kernel_flops``, the backward by its backward kernels'
  ``backward_flops``;
* **HBM traffic** — a ``TorchDispatchMode`` that adds each op's operand
  and output bytes (views and allocations move none), plus each kernel's
  ``kernel_hbm_bytes``.  Eager mode fuses nothing, so this is an upper
  bound on what a fused step would move;
* **peak memory** — the high-water mark of the storages the step makes,
  followed by their lifetimes (a storage counts from the op that makes it
  until its last tensor is freed);
* **collective bytes** — what the step's shape-only groups
  (:class:`~repro_torch.parallel.collectives.ShapeGroup`) charge, by kind
  and by group, and the largest sources.

:meth:`OpAnalysis.repeat` runs a stretch of the step as ``k`` identical
copies: every count made inside it counts ``k`` times (the dry-run traces
one training microbatch for the ``microbatches - 1`` that follow the
first).  :class:`OpReport` has ``HloReport``'s fields where they mean
something here; ``trip_counts`` stays empty, since eager mode has no
loops to correct.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import costs

__all__ = ["OpReport", "OpAnalysis", "analyze_step", "NOTES"]

# ops that allocate without writing, or alias: they move no bytes
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "set_"}

NOTES = (
    "HBM bytes: every op's operand and output bytes, eager and unfused, so an upper bound; "
    "views and allocations move none",
    "dot FLOPs: FlopCounterMode's count of every op, plus the kernels' meta routes priced by "
    "kernel_flops",
    "K4 and K5 forward: priced by kernel_flops / kernel_hbm_bytes, not launched; their "
    "backward: priced by their backward kernels' backward_flops / backward_hbm_bytes, "
    "what the card runs",
    "peak: the step's arguments plus the high-water mark of the storages it makes",
    "trip_counts: empty, eager mode has no loops to correct",
)


@dataclasses.dataclass
class OpReport:
    dot_flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    collective_count: int
    trip_counts: Dict[str, int]
    notes: List[str]
    # (group/kind, tensor type, count, total bytes), largest first
    top_collectives: List[Tuple[str, str, float, float]] = dataclasses.field(
        default_factory=list)
    # (op, output type, count, total bytes), largest first
    top_traffic: List[Tuple[str, str, float, float]] = dataclasses.field(default_factory=list)
    # the port's own: the kernels' priced share, bytes by group, the peak
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    collective_by_group: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    temp_peak_bytes: int = 0
    ops: int = 0

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_peak_bytes

    def as_dict(self) -> dict:
        return dict(dataclasses.asdict(self), peak_bytes=self.peak_bytes)


def _type(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpAnalysis(TorchDispatchMode):
    """The counting mode; :func:`analyze_step` drives it.  It is also the
    active cost report (``repro_torch.costs``) while it runs."""

    def __init__(self) -> None:
        super().__init__()
        self.scale = 1
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.hbm = 0.0
        self.ops = 0
        self.traffic: Dict[Tuple[str, str], List[float]] = defaultdict(lambda: [0.0, 0.0])
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "hbm_bytes": 0.0})
        self.collectives: Dict[Tuple[str, str, str], List[float]] = defaultdict(
            lambda: [0.0, 0.0])
        self._live: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    # -- the cost report's interface (repro_torch.costs) --------------------
    def charge_kernel(self, name: str, flops: float, hbm_bytes: float) -> None:
        k = self.kernels[name]
        k["calls"] += self.scale
        k["flops"] += flops * self.scale
        k["hbm_bytes"] += hbm_bytes * self.scale

    def charge_collective(self, group: str, kind: str, shape, dtype, nbytes: int) -> None:
        key = (group, kind, f"{str(dtype).replace('torch.', '')}{list(shape)}")
        self.collectives[key][0] += self.scale
        self.collectives[key][1] += nbytes

    # -- repetition ----------------------------------------------------------
    @contextlib.contextmanager
    def repeat(self, k: int):
        """Count what runs inside as ``k`` identical copies of it."""
        outer = self.scale
        self.scale = outer * k
        try:
            yield
        finally:
            self.scale = outer

    # -- the ops -----------------------------------------------------------
    def _made(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        packet = func.overloadpacket
        name = packet.__name__
        self.ops += self.scale
        count = self.flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **(kwargs or {}), out_val=out) * self.scale
        if not func.is_view and name not in _NO_TRAFFIC:
            moved = sum(_bytes(t) for t in _tensors((args, kwargs))) + sum(map(_bytes, outs))
            self.hbm += moved * self.scale
            entry = self.traffic[(name, _type(outs[0]) if outs else "")]
            entry[0] += self.scale
            entry[1] += moved * self.scale
        for t in outs:
            if t.device.type == "meta":
                self._made(t)
        return out

    def report(self, argument_bytes: int) -> OpReport:
        by_kind: Dict[str, float] = defaultdict(float)
        by_group: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        for (group, kind, _), (_, nbytes) in self.collectives.items():
            by_kind[kind] += nbytes
            by_group[group][kind] += nbytes
        kernels = {k: dict(v) for k, v in self.kernels.items()}
        top_c = sorted(((f"{g}/{k}", typ, n, b) for (g, k, typ), (n, b)
                        in self.collectives.items()), key=lambda r: -r[3])
        top_t = sorted(((op, typ, n, b) for (op, typ), (n, b) in self.traffic.items()),
                       key=lambda r: -r[3])
        return OpReport(
            dot_flops=self.flops + sum(k["flops"] for k in kernels.values()),
            hbm_bytes=self.hbm + sum(k["hbm_bytes"] for k in kernels.values()),
            collective_bytes=float(sum(by_kind.values())),
            collective_by_kind=dict(by_kind),
            collective_count=int(sum(n for n, _ in self.collectives.values())),
            trip_counts={},
            notes=list(NOTES),
            top_collectives=top_c[:12],
            top_traffic=top_t[:12],
            kernels=kernels,
            collective_by_group={g: dict(v) for g, v in by_group.items()},
            argument_bytes=argument_bytes,
            temp_peak_bytes=self.peak,
            ops=int(self.ops),
        )


def analyze_step(fn: Callable[..., Any], *args, analysis: OpAnalysis = None,
                 **kwargs) -> OpReport:
    """Run ``fn(*args, **kwargs)`` once (on ``meta`` tensors) under an
    :class:`OpAnalysis` (or the one given, to reach its :meth:`repeat`
    from inside ``fn``), and report it.  The arguments' bytes count once
    toward the peak."""
    analysis = OpAnalysis() if analysis is None else analysis
    seen, argument_bytes = set(), 0
    for t in _tensors((args, kwargs)):
        storage = t.untyped_storage()
        if id(storage) not in seen:
            seen.add(id(storage))
            argument_bytes += storage.nbytes()
    with costs.pricing(analysis), analysis:
        out = fn(*args, **kwargs)
    del out
    return analysis.report(argument_bytes)

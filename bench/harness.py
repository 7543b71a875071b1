"""One run of one training cell: set-up, the measured window, the traced
window, and the comparison with the plain reference that decides
``correct``.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``; each
per-layer metric it reports is read by ``metrics/<metric>.py``, which
declares the program's launch counters it reads (``COUNTERS``); the
configuration's model family brings its reference and FLOP count
(``families/<family>.py``).  A configuration's ``model`` group may set
those fields of the program's ``ParallelConfig`` under ``"parallel"`` that
its family's reference follows (:data:`PARALLEL`).

The system under test is the port's training step:
``repro_torch.launch.steps.make_train_step`` over the model of
``repro_torch.models.make_model`` and ``repro_torch.optim.AdamW``, on a
mesh of one rank.  Set-up builds that one step object, its weights and
its AdamW state, and drives it from the seed through its first
``CHECK_STEPS`` steps with the window's own call and feed; the window
then goes on with the same objects.  Steps are dispatched ahead: the
harness reads nothing back from the device inside the window, which ends
with one ``synchronize()``.  The traced window runs with the program's
spans on (``repro_torch.tracing``); the measured window with them off.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from . import check, families, inputs
from .reference.model import padded_vocab, param_spec
from .reference.precision import PRODUCTS, strict_float32
from .reference.train import DTYPES, reference_steps
from .spans import idle_gaps_by_span, read_spans
from .trace import breakdown, busy_intervals

__all__ = ["BENCH", "CHECK_STEPS", "FORBIDDEN", "Forbidden", "load_cell", "run",
           "forbidden_modules", "program_readings", "reference_readings", "reference_rows",
           "declared_counters", "read_counter"]

BENCH = Path(__file__).resolve().parent
# the JAX package, its benchmarks and JAX itself: compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the steps that both sides take before the window: every limit in limits/ was
# read at this count, so changing it means reading them all again
CHECK_STEPS = 2
# the ParallelConfig fields that a configuration's "parallel" may set, where its
# family's reference follows them (the family's PARALLEL): they change which
# tokens an expert takes and how, never a precision, the microbatches, remat,
# or a field that nothing reads
PARALLEL = ("capacity_factor", "moe_dispatch", "moe_fallback")
# the reference's rows a block: as many as keep a block's residual stream
# (rows x seq_len x d_model values) within this, and at least one
REFERENCE_BLOCK_VALUES = 1 << 24


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the process that measures."""


def forbidden_modules(names=None) -> List[str]:
    """The top-level names among ``names`` (default ``sys.modules``) that
    are JAX's or the JAX package's, compared whole."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_cell(name: str, manifest: Optional[Dict] = None) -> Dict:
    """{"name", "config", "traffic", "chips", "end_to_end", "per_layer",
    "limits"} of the cell ``name``, from ``BENCHMARK.json`` at the root of
    the checkout and the files it names."""
    if manifest is None:
        manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def here(metric):
        return name in metric.get("workloads", cells)

    return {"name": name, "chips": w["chips"],
            "config": json.loads((BENCH / "configs" / f"{w['config']}.json").read_text()),
            "traffic": json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
            "end_to_end": [m for m in manifest["end_to_end"] if here(m)],
            "per_layer": [m for m in manifest["per_layer"] if here(m)],
            "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text())}


def _metric(name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def declared_counters(cell: Dict) -> List[str]:
    """The program's counters that the cell's per-layer metrics declare
    (each reader's ``COUNTERS``), sorted, each once."""
    return sorted({c for m in cell["per_layer"]
                   for c in getattr(_metric(m["name"]), "COUNTERS", ())})


def read_counter(name: str) -> int:
    """The counter ``"<k>.<attr>"``: the attribute ``attr`` of the kernel
    wrapper ``repro_torch.kernels.<k>.<k>.<k>``."""
    k, attr = name.split(".")
    return getattr(getattr(importlib.import_module(f"repro_torch.kernels.{k}.{k}"), k), attr)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The port's training step for one cell, with its weights and state."""

    def __init__(self, cell: Dict, device) -> None:
        from repro_torch.configs import get_config
        from repro_torch.configs.base import InputShape
        from repro_torch.launch.steps import GRAD_CLIP, make_train_step
        from repro_torch.models import make_model
        from repro_torch.optim import AdamW
        from repro_torch.parallel.mesh_rules import MeshRules, MeshShape
        from repro_torch.tree import tree_leaves_with_path

        m, t = cell["config"]["model"], cell["traffic"]
        base = get_config(m["arch"])
        # the family names the benchmark's reference; the program's is its arch's
        fields = {f.name for f in dataclasses.fields(base)} - {"family", "parallel"}
        parallel = m.get("parallel", {})
        allowed = set(PARALLEL) & set(getattr(families.load(m["family"]), "PARALLEL", ()))
        refused = sorted(set(parallel) - allowed)
        if refused:
            raise ValueError(f"{refused} under the model's \"parallel\": a configuration sets "
                             f"only those of {list(PARALLEL)} that its family's reference "
                             f"follows ({sorted(allowed)})")
        cfg = base.replace(**{k: v for k, v in m.items() if k in fields},
                           parallel=dataclasses.replace(base.parallel, remat=m["remat"],
                                                        **parallel))
        if cfg.padded_vocab != padded_vocab(m):
            raise ValueError(f"the program pads the vocabulary to {cfg.padded_vocab}, the "
                             f"configuration to {padded_vocab(m)}")
        if GRAD_CLIP != t["grad_clip"]:
            raise ValueError(f"the program clips at {GRAD_CLIP}, the traffic at {t['grad_clip']}")
        self.cell, self.device, self.m, self.t = cell, device, m, t
        self.model = make_model(cfg, device=device)
        opt = t["adamw"]
        self.optimizer = AdamW(opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], cfg=cfg,
                               state_dtype=DTYPES[opt["state_dtype"]])
        rules = MeshRules(MeshShape((1, 1), ("data", "model")), cfg.parallel)
        shape = InputShape("train", t["seq_len"], t["global_batch"], "train")
        self.step = make_train_step(self.model, self.optimizer, rules, shape, lr=t["lr"],
                                    loss_chunk=t["loss_chunk"], microbatches=t["microbatches"])
        if self.step.microbatches != t["microbatches"]:
            raise ValueError(f"the step runs {self.step.microbatches} microbatches, the traffic "
                             f"asks for {t['microbatches']}")
        self.spec = param_spec(m)
        want = {p: (tuple(s), DTYPES[m["param_dtype"]]) for p, s, *_ in self.spec}
        got = {p: (tuple(a.shape), a.dtype)
               for p, a in tree_leaves_with_path(self.model.abstract_params())}
        if got != want:
            raise ValueError("the program's parameter tree is not the reference's: "
                             f"{sorted(map(str, set(got.items()) ^ set(want.items())))[:4]}")
        self.paths = [p for p, *_ in self.spec]

    def weights(self, seed: int):
        return inputs.make_weights(self.spec, seed, self.device, DTYPES[self.m["param_dtype"]])

    def batch(self, seed: int, k: int) -> Dict[str, torch.Tensor]:
        t = self.t
        return inputs.make_batch(seed, k, t["global_batch"], t["seq_len"], self.m["vocab_size"],
                                 self.device)


def program_readings(prog: Program, seed: int):
    """Drive the step from the seed through its first ``CHECK_STEPS``
    steps -> ((params, opt_state) to go on from, {"losses", "grads",
    "changes"} as device tensors: per-step losses, per-leaf norms of the
    first clipped gradient (from AdamW's first moment) and of the weights'
    change)."""
    from repro_torch.tree import tree_leaves_with_path

    params = inputs.tree_of(prog.weights(seed))
    opt_state = prog.optimizer.init(params)
    b1 = prog.t["adamw"]["b1"]
    losses, grads = [], None
    for k in range(CHECK_STEPS):
        params, opt_state, metrics = prog.step(params, opt_state, prog.batch(seed, k))
        losses.append(metrics["loss"])
        if k == 0:
            mu = dict(tree_leaves_with_path(opt_state.mu))
            grads = torch.stack([mu[p].float().norm() for p in prog.paths]) / (1 - b1)
    now = dict(tree_leaves_with_path(params))
    start = dict(prog.weights(seed))
    changes = torch.stack([(now[p].float() - start[p].float()).norm() for p in prog.paths])
    del start, now
    return (params, opt_state), {"losses": torch.stack(losses), "grads": grads,
                                 "changes": changes}


def reference_readings(prog: Program, seed: int, precision: str = "float32") -> Dict:
    """The reference's readings of the same first steps, in float32 (or
    the control's ``precision``)."""
    strict_float32()
    m, t = prog.m, prog.t
    leaves = [(p, x.float()) for p, x in prog.weights(seed)]
    batches = []
    for k in range(CHECK_STEPS):
        b = prog.batch(seed, k)
        batches.append((b["tokens"], b["labels"]))
    return reference_steps(leaves, batches, m, t, PRODUCTS[precision], reference_rows(m, t))


def reference_rows(m: Dict, t: Dict) -> int:
    """The reference's rows a block for the model ``m`` under the traffic ``t``."""
    return max(1, REFERENCE_BLOCK_VALUES // (t["seq_len"] * m["d_model"]))


def _window(prog: Program, seed: int, state, seconds: float, k0: int):
    params, opt_state = state
    losses = []
    k = k0
    t0 = time.perf_counter()
    while True:
        params, opt_state, metrics = prog.step(params, opt_state, prog.batch(seed, k))
        losses.append(metrics["loss"])
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(prog.device)
    return time.perf_counter() - t0, losses, (params, opt_state)


def _traced_window(prog: Program, seed: int, state, k0: int):
    """``trace_steps`` steps under the profiler with the program's spans on
    -> (the trace's ``SpanView``, the losses, the state to go on from)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing

    names = declared_counters(prog.cell)
    before = {n: read_counter(n) for n in names}
    params, opt_state = state
    steps, losses = prog.t["trace_steps"], []
    acts = [ProfilerActivity.CPU]
    if torch.device(prog.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tracing.enable(True)
    try:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                for k in range(k0, k0 + steps):
                    with record_function("bench.batch"):
                        batch = prog.batch(seed, k)
                    with record_function("bench.grads"):
                        grads, metrics = prog.step.grads(params, batch)
                    with record_function("bench.update"):
                        params, opt_state, metrics = prog.step.update(params, opt_state, grads,
                                                                      metrics)
                    losses.append(metrics["loss"])
                    del grads
                with record_function("bench.sync"):
                    _sync(prog.device)
    finally:
        tracing.enable(False)
    counters = {n: read_counter(n) - before[n] for n in names}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        view = read_spans(path, steps, {"model": prog.m, "traffic": prog.t}, counters)
    finally:
        os.remove(path)
    return view, losses, (params, opt_state)


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, started: float,
        log=print) -> Tuple[Dict, List[str]]:
    """One run -> (the result object, the lines that compare each number
    with its limit).  ``started``: ``time.perf_counter()`` at the process's
    start.  Raises :class:`Forbidden` if JAX or the JAX package is loaded
    once the window has closed."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    prog = Program(cell, device)
    t1 = time.perf_counter()
    t = prog.t
    state, mine = program_readings(prog, seed)
    _sync(device)
    from repro_torch import _build

    log(f"set-up: {t0 - started:.2f} s to the harness, {t1 - t0:.2f} s the program's objects, "
        f"{time.perf_counter() - t1:.2f} s weights and the first {CHECK_STEPS} steps; kernel "
        f"libraries {json.dumps(_build.setup_seconds())}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started
    k0 = CHECK_STEPS
    tokens_per_step = t["global_batch"] * t["seq_len"]
    extra: Dict = {}
    if trace:
        view, losses, state = _traced_window(prog, seed, state, k0)
        readings = {m["name"]: (_metric(m["name"]).read(view), m["unit"])
                    for m in cell["per_layer"]}
        # the idle gaps each by the program's span of the op that ends it
        extra["breakdown"] = dict(breakdown(view), idle_gaps=idle_gaps_by_span(view))
        device_extra = {"busy_s": sum(b - a for a, b in busy_intervals(view.ops)) / 1e6,
                        "window_s": view.window_s}
    else:
        elapsed, losses, state = _window(prog, seed, state, seconds, k0)
        measured = {"train_tokens_per_s": len(losses) * tokens_per_step / elapsed,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
                    "setup_s": setup_s}
        readings = {m["name"]: (measured[m["name"]], m["unit"]) for m in cell["end_to_end"]}
        device_extra = {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {n: {"value": v, "unit": u} for n, (v, u) in readings.items() if v is not None}
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded once the window closed: {', '.join(found)}")
    window_losses = torch.stack(losses).float().cpu()
    mine = {k: v.float().cpu().tolist() for k, v in mine.items()}
    del state, losses, prog.step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window done; reference from seed {seed}")
    ref = reference_readings(prog, seed)
    values = check.numbers(mine, ref)
    limits = cell["limits"]["limits"]
    failed = int((~torch.isfinite(window_losses)).sum())
    result = {"correct": check.verdict(values, limits) and failed == 0,
              "attempted": len(window_losses), "failed": failed, "metrics": metrics, **extra,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name() if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak, **device_extra},
              "checks": {k: {"value": values[k], "limit": limits[k]} for k in check.NAMES}}
    lines = [f"{k} {values[k]!r} limit "
             + ("none (not compared)" if limits[k] is None else repr(limits[k]))
             for k in check.NAMES]
    return result, lines

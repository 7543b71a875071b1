"""The program's spans over one cell's traced window, and what they cost.

    python3 bench/span_report.py --workload <cell> --seed <n> --seconds 30 --pairs 2

In one process: the program's objects and its first steps from the seed
(``harness.program_readings``), with the kernel libraries this process
built and loaded (``repro_torch._build.setup_seconds``); the harness's
traced window (``harness._traced_window``, which turns the program's spans
on, ``repro_torch.tracing.enable``, and reads them by
``spans.read_spans``): the cell's per-layer metrics of ``BENCHMARK.json``,
device ms a step by innermost span, the device ms of the blocks' first
forwards, the host ms a step in each span and in the CUDA runtime's calls
under it, and ``idle_gaps_by_span``; the host µs of one span, off, on,
and on under the profiler; then ``--pairs`` pairs of untraced windows
of ``--seconds`` each, spans off and on in turns (off, on, on, off, …),
with the tokens a second of each.  Prints one JSON object as the last
line of standard output.  The benchmark's own runs never run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PROBES = 20000


def span_cost_us(device) -> dict:
    """Host µs of one ``with tracing.span(...)``: spans off, on, and on
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    def per_span():
        t0 = time.perf_counter()
        for _ in range(PROBES):
            with tracing.span("probe"):
                pass
        return 1e6 * (time.perf_counter() - t0) / PROBES

    out = {}
    try:
        tracing.enable(False)
        out["off"] = per_span()
        tracing.enable(True)
        out["on"] = per_span()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts):
            out["on_traced"] = per_span()
    finally:
        tracing.enable(False)
    return out


def by_span(view) -> dict:
    """{innermost span (or the op's bench.* range): [device ms a step,
    of which at::native ms]}, largest first."""
    table = {}
    for op in view.ops:
        key = op.span.name if op.span is not None else op.range
        row = table.setdefault(key, [0.0, 0.0])
        row[0] += op.dur / 1e3 / view.steps
        if "at::native::" in op.name:
            row[1] += op.dur / 1e3 / view.steps
    return dict(sorted(table.items(), key=lambda kv: -kv[1][0]))


def host_by_span(path, view) -> dict:
    """{span name: [host ms a step the spans of that name last, host ms a
    step in CUDA runtime calls (launches, and their waits for a slot in
    the launch queue) made while it was the innermost span]}."""
    from bench.spans import innermost_at
    from bench.trace import LAUNCH_CATS

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    innermost = innermost_at(view.spans)
    table = {}
    for s in view.spans:
        table.setdefault(s.name, [0.0, 0.0])[0] += (s.end - s.start) / 1e3 / view.steps
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in LAUNCH_CATS:
            s = innermost(float(e["ts"]))
            if s is not None:
                table[s.name][1] += float(e.get("dur", 0)) / 1e3 / view.steps
    return table


def report(cell, seed: int, device, seconds: float, pairs: int, log=print) -> dict:
    import torch

    from bench import harness
    from bench.harness import Program, program_readings
    from bench.spans import first_run, idle_gaps_by_span, read_spans
    from bench.trace import breakdown
    from repro_torch import _build, tracing

    t0 = time.perf_counter()
    prog = Program(cell, device)
    state, _ = program_readings(prog, seed)
    harness._sync(device)
    out = {"workload": cell["name"], "seed": seed,
           "device": torch.cuda.get_device_name() if device == "cuda" else "cpu",
           "setup": {"to_harness_s": t0 - STARTED, "program_s": time.perf_counter() - t0,
                     "libraries": _build.setup_seconds()}}
    log(f"set-up done: {out['setup']}")

    # the harness's traced window (the program's spans on); the trace is read
    # once more, for the host's time in each span, before the harness removes it
    views, hosts = [], []

    def reading(path, steps, cell_, counters):
        views.append(read_spans(path, steps, cell_, counters))
        hosts.append(host_by_span(path, views[-1]))
        return views[-1]

    k = harness.CHECK_STEPS
    harness.read_spans = reading
    try:
        _, losses, state = harness._traced_window(prog, seed, state, k)
    finally:
        harness.read_spans = read_spans
    k += len(losses)
    view = views[0]
    out["metrics"] = {m["name"]: harness._metric(m["name"]).read(view) for m in cell["per_layer"]}
    rerun_free = {s for s in view.spans if first_run(view, s)}
    out["first_run_block_ms"] = 1e3 * view.seconds(
        [op for op in view.ops if op.span in rerun_free]) / view.steps
    out["loss_at_native_ms"] = 1e3 * view.seconds(
        [op for op in view.matching(r"at::native::")
         if op.span is not None and op.span.name.startswith("repro.loss")]) / view.steps
    out["spans_a_step"] = len(view.spans) / view.steps
    out["by_span"] = by_span(view)
    out["host_by_span"] = hosts[0]
    out["breakdown"] = breakdown(view)
    out["idle_gaps_by_span"] = idle_gaps_by_span(view)
    del views, view
    log(f"traced window done: {out['metrics']}")

    out["span_us"] = span_cost_us(device)
    tokens = cell["traffic"]["global_batch"] * cell["traffic"]["seq_len"]
    runs = []
    for on in [x for _ in range(pairs) for x in (False, True, True, False)][:2 * pairs]:
        tracing.enable(on)
        try:
            elapsed, losses, state = harness._window(prog, seed, state, seconds, k)
        finally:
            tracing.enable(False)
        k += len(losses)
        runs.append({"spans": on, "steps": len(losses),
                     "train_tokens_per_s": len(losses) * tokens / elapsed})
        log(f"window: {runs[-1]}")
    out["cost"] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    # run.py's kernel caches
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "bench" / "torch-kernels")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "bench" / "cuda-cache")

    import torch

    from bench.harness import load_cell

    if not torch.cuda.is_available():
        print("span_report: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = report(load_cell(args.workload), args.seed, "cuda", args.seconds, args.pairs,
                 log=lambda s: print(f"span_report: {s}", file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readers of the program's spans (``spans.py`` and the five metrics
that read them) on a hand-built trace, the six metrics of
``BENCHMARK.json`` reading the same numbers with and without the
program's spans in the trace, and ``span_report.py`` on the CPU at tiny
sizes."""

import importlib.util
import json

import pytest

from tiny import CELLS, tiny_cell
from bench import span_report
from bench.harness import BENCH, load_cell
from bench.spans import idle_gaps_by_span, read_spans
from bench.trace import breakdown, read_trace

MAIN, AUTOGRAD = 1, 2        # host threads
NATIVE = "at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
GEMM = "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT"
FLASH = "void flash_fwd_bf16_wide<160>(Params)"

# the benchmark's ranges, on the main thread
BENCH_RANGES = [("bench.window", 0, 1000), ("bench.batch", 0, 50), ("bench.grads", 50, 700),
                ("bench.update", 700, 950), ("bench.sync", 950, 1000)]
# the program's spans: (name, start, end, thread); the backward's on autograd's thread
SPANS = [("repro.block.attn", 60, 120, MAIN), ("repro.loss", 130, 180, MAIN),
         ("repro.backward", 200, 650, MAIN), ("repro.loss.backward", 210, 260, AUTOGRAD),
         ("repro.block.attn.backward", 270, 600, AUTOGRAD),
         ("repro.block.attn", 280, 330, AUTOGRAD), ("repro.accumulate", 660, 690, MAIN),
         ("repro.update", 700, 940, MAIN), ("repro.update.clip", 710, 740, MAIN),
         ("repro.update.adamw", 745, 900, MAIN), ("repro.update.apply", 905, 930, MAIN)]
# device ops: (name, launched at, host thread, start on the device, duration, the
# innermost span of the launch); launched None: the launch is not in the trace
OPS = [
    (NATIVE, 20, MAIN, 40, 4, None),                         # under bench.batch
    (NATIVE, 70, MAIN, 100, 10, "repro.block.attn"),         # the first forward
    (GEMM, 90, MAIN, 110, 20, "repro.block.attn"),
    (NATIVE, 150, MAIN, 160, 6, "repro.loss"),
    (GEMM, 170, MAIN, 166, 14, "repro.loss"),
    (NATIVE, 190, MAIN, 190, 2, None),                       # under bench.grads
    (NATIVE, 220, AUTOGRAD, 230, 8, "repro.loss.backward"),
    (NATIVE, 265, AUTOGRAD, 262, 3, "repro.backward"),       # between its parts
    (NATIVE, 290, AUTOGRAD, 300, 12, "repro.block.attn"),    # the re-run
    (GEMM, 300, AUTOGRAD, 312, 30, "repro.block.attn"),
    (FLASH, 305, AUTOGRAD, 312, 10, "repro.block.attn"),
    (NATIVE, 400, AUTOGRAD, 400, 16, "repro.block.attn.backward"),
    (GEMM, 410, AUTOGRAD, 420, 40, "repro.block.attn.backward"),
    (NATIVE, 665, MAIN, 665, 18, "repro.accumulate"),
    (NATIVE, 720, MAIN, 720, 5, "repro.update.clip"),
    (NATIVE, 800, MAIN, 800, 7, "repro.update.adamw"),
    (NATIVE, 910, MAIN, 912, 3, "repro.update.apply"),
    ("ssd_bwd_kernel", None, None, 960, 1, None),
]
STEPS = 2
COUNTERS = {"flash_attention.launches": 3, "flash_attention.backward_launches": 1,
            "ssd_scan.launches": 2, "ssd_scan.backward_launches": 1}


def trace_events(with_spans=True):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
               "pid": 1, "tid": MAIN} for n, a, b in BENCH_RANGES]
    if with_spans:
        events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
                    "pid": 1, "tid": t} for n, a, b, t in SPANS]
    for k, (name, launched, thread, start, dur, _) in enumerate(OPS):
        args = {} if launched is None else {"correlation": k}
        if launched is not None:
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": launched, "dur": 1, "pid": 1, "tid": thread, "args": args})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                       "pid": 0, "tid": 7, "args": args})
    return events


def write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def info(name=CELLS[0]):
    cell = load_cell(name)
    return {"model": cell["config"]["model"], "traffic": cell["traffic"]}


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.fixture
def path(tmp_path):
    return write(tmp_path / "spans.json", trace_events())


@pytest.fixture
def view(path):
    return read_spans(path, STEPS, info(), COUNTERS)


def test_each_op_takes_its_innermost_span(path, view):
    assert [op.span.name if op.span else None for op in view.ops] == [o[-1] for o in OPS]
    # the re-run's span is the autograd thread's, not the first forward's
    assert view.ops[8].span.thread == AUTOGRAD and view.ops[1].span.thread == MAIN
    plain = read_trace(path, STEPS, info(), COUNTERS)
    assert [(op.name, op.start, op.dur, op.range) for op in view.ops] == \
        [(op.name, op.start, op.dur, op.range) for op in plain.ops]
    assert sorted((s.name, s.start, s.end, s.thread) for s in view.spans) == sorted(SPANS)


@pytest.mark.parametrize("name, us", [
    ("loss_ms.train", 6 + 14 + 8),
    ("accumulate_ms.train", 18),
    ("recompute_ms.train", 12 + 30 + 10),
    ("block_eager_ms.train", 10 + 12 + 16),
])
def test_device_span_metrics_by_hand(view, name, us):
    assert reader(name)(view) == pytest.approx(us / 1e3 / STEPS, rel=1e-12)


def test_update_host_ms_by_hand(view):
    assert reader("update_host_ms.train")(view) == pytest.approx((940 - 700) / 1e3 / STEPS)


@pytest.mark.parametrize("name", ["loss_ms.train", "accumulate_ms.train", "recompute_ms.train",
                                  "block_eager_ms.train", "update_host_ms.train"])
def test_span_metrics_read_nothing_without_spans(tmp_path, name):
    path = write(tmp_path / "plain.json", trace_events(False))
    assert reader(name)(read_trace(path, STEPS, info(), COUNTERS)) is None
    assert reader(name)(read_spans(path, STEPS, info(), COUNTERS)) is None


def test_one_microbatch_has_no_accumulation(tmp_path):
    events = [e for e in trace_events() if e["name"] != "repro.accumulate"]
    one = read_spans(write(tmp_path / "one.json", events), STEPS, info(), COUNTERS)
    assert reader("accumulate_ms.train")(one) is None
    assert reader("loss_ms.train")(one) is not None


def test_idle_gaps_by_span(view):
    gaps = idle_gaps_by_span(view)
    assert [g[1] for g in gaps] == [g[1] for g in breakdown(view)["idle_gaps"]]
    # each gap by the span of the op that ends it, else that op's bench.* range
    # ("unknown" where its launch is not in the trace)
    assert gaps == [[n, us / 1e6] for n, us in [
        ("repro.accumulate", 205), ("repro.update.apply", 105), ("repro.update.adamw", 75),
        ("repro.block.attn.backward", 58), ("repro.block.attn", 56), ("unknown", 45),
        ("bench.batch", 40), ("bench.sync", 39), ("repro.loss.backward", 38),
        ("repro.update.clip", 37)]]


def test_host_by_span(path, view):
    table = span_report.host_by_span(path, view)
    # each launch call lasts 1 µs; the update's spans on the host
    assert table["repro.update"] == pytest.approx([240 / 1e3 / STEPS, 0.0])
    assert table["repro.update.adamw"] == pytest.approx([155 / 1e3 / STEPS, 1 / 1e3 / STEPS])
    assert table["repro.block.attn"] == pytest.approx([(60 + 50) / 1e3 / STEPS, 5 / 1e3 / STEPS])
    assert set(table) == {s[0] for s in SPANS}


@pytest.mark.parametrize("name, cell", [
    ("mfu.train", CELLS[0]), ("eager_ops_ms.train", CELLS[0]),
    ("optimizer_ms.train", CELLS[0]), ("k4_roofline.train", CELLS[0]),
    ("k5_roofline.train", CELLS[1]), ("device_idle_share.train", CELLS[0])])
def test_the_benchmarks_readers_ignore_the_spans(tmp_path, name, cell):
    plain = write(tmp_path / "plain.json", trace_events(False))
    traced = write(tmp_path / "spans.json", trace_events())
    value = reader(name)(read_trace(plain, STEPS, info(cell), COUNTERS))
    assert value is not None
    assert reader(name)(read_trace(traced, STEPS, info(cell), COUNTERS)) == value
    assert reader(name)(read_spans(traced, STEPS, info(cell), COUNTERS)) == value


@pytest.mark.parametrize("name", CELLS)
def test_span_report_on_the_cpu(name):
    cell = tiny_cell(name)
    out = span_report.report(cell, 2**31 + 29, "cpu", 0.2, 1, log=lambda s: None)
    mb = cell["traffic"]["microbatches"]
    layers = cell["config"]["model"]["num_layers"]
    # a microbatch: each block's forward, re-run and backward, the loss and its
    # backward, the backward, and the sum where there are several; a step's update
    assert out["spans_a_step"] == mb * (3 * layers + 3 + (mb > 1)) + 4
    metrics = out["metrics"]
    assert metrics["update_host_ms.train"] > 0
    assert (metrics.get("accumulate_ms.train") is None) == (mb == 1)
    assert out["host_by_span"]["repro.update"][0] > 0
    assert [r["spans"] for r in out["cost"]] == [False, True]
    assert all(r["train_tokens_per_s"] > 0 for r in out["cost"])
    assert out["span_us"]["off"] < out["span_us"]["on"]


def test_conv_roofline_by_hand(tmp_path):
    """``causal_conv_roofline.train`` over a trace of the mamba2 cell's conv
    kernels: the counters' calls at their least time over the kernels'."""
    from bench.flops import conv_backward, conv_forward, least_seconds

    ops = [("void (anonymous namespace)::causal_conv_fwd_kernel<__nv_bfloat16, 8, true>(Args)",
            0, 300), ("void (anonymous namespace)::causal_conv_bwd_kernel<__nv_bfloat16, 8, true>"
                      "(Args)", 400, 500),
           ("void (anonymous namespace)::causal_conv_bwd_sum_kernel<__nv_bfloat16>(Args)", 950, 10),
           (NATIVE, 970, 20)]
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0,
               "dur": 1000, "pid": 1, "tid": MAIN}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": d, "pid": 0, "tid": 7}
               for n, a, d in ops]
    counters = {"causal_conv.launches": 2, "causal_conv.backward_launches": 1}
    view = read_spans(write(tmp_path / "conv.json", events), 1, info(CELLS[1]), counters)
    least = 2 * least_seconds(*conv_forward(32, 2048, 1792, 4)) \
        + least_seconds(*conv_backward(32, 2048, 1792, 4))
    assert reader("causal_conv_roofline.train")(view) == pytest.approx(100 * least / 810e-6)
    plain = read_spans(write(tmp_path / "spans.json", trace_events()), STEPS, info(), COUNTERS)
    assert reader("causal_conv_roofline.train")(plain) is None      # no conv kernel

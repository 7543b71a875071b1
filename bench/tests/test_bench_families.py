"""The family contract (``families/<family>.py``), the configuration's
``parallel`` group, the launch counters the readers declare, and the
traced window's spans, on the CPU at tiny sizes."""

import json
import time

import pytest
import torch

from tiny import CELLS, ROOT, tiny_cell
from bench import families, harness
from bench.harness import (BENCH, Program, declared_counters, load_cell, read_counter,
                           reference_readings, run)

CONTRACT = ("TINY", "param_spec", "matmul_weights", "mixer_flops")
BEFORE = json.loads((BENCH / "tests" / "tiny_reference_readings.json").read_text())["readings"]
# a microbatch's loss of its own that counts its calls, appended to a copy of dense.py
COUNTING = """

from bench.reference.model import blocked_loss

CALLS = []


def microbatch_loss(tree, tokens, *args):
    CALLS.append(tokens.shape)
    return blocked_loss(tree, tokens, *args, layer=layer)
"""


@pytest.mark.parametrize("path", sorted(families.DIR.glob("[!_]*.py")), ids=lambda p: p.stem)
def test_each_family_gives_the_contract(path):
    module = families.load(path.stem)
    assert all(hasattr(module, name) for name in CONTRACT)
    assert hasattr(module, "layer") or hasattr(module, "microbatch_loss")


def test_every_configuration_has_its_family():
    for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]:
        families.load(json.loads((ROOT / c["file"]).read_text())["model"]["family"])


def test_a_missing_family_names_its_file(monkeypatch, tmp_path):
    monkeypatch.setattr(families, "DIR", tmp_path)
    with pytest.raises(LookupError, match="moe.py"):
        families.load("moe")


def test_a_new_family_is_a_new_file(monkeypatch, tmp_path):
    """A family found in another directory, a copy of ``dense.py`` under
    another name, runs a whole tiny cell with no other file changed: the
    reference walks the program's microbatches through it."""
    (tmp_path / "dense_copy.py").write_text((families.DIR / "dense.py").read_text() + COUNTING)
    monkeypatch.setattr(families, "DIR", tmp_path)
    cell = tiny_cell(CELLS[0], "float32", family="dense_copy")
    result, lines = run(cell, 2**31 + 41, 0.2, False, "cpu", time.perf_counter(),
                        log=lambda s: None)
    assert result["correct"], lines
    calls = families.load("dense_copy").CALLS
    t = cell["traffic"]
    rows = t["global_batch"] // t["microbatches"]
    assert calls == [(rows, t["seq_len"])] * (t["microbatches"] * harness.CHECK_STEPS)


@pytest.mark.parametrize("key", sorted(BEFORE))
def test_the_reference_keeps_its_bits(key):
    """The reference's readings of the tiny cells, bit for bit as they were
    before its families were files of their own."""
    name, dtype, precision = key.split("/")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = reference_readings(Program(tiny_cell(name, dtype), "cpu"), 11, precision)
    finally:
        torch.set_num_threads(threads)
    assert {k: [v.hex() for v in got[k]] for k in BEFORE[key]} == BEFORE[key]


# a family whose reference follows the experts' capacity and overflow
FOLLOWING = """

PARALLEL = ("capacity_factor", "moe_fallback")
"""


def _following(monkeypatch, tmp_path):
    (tmp_path / "dense_moe.py").write_text((families.DIR / "dense.py").read_text() + FOLLOWING)
    monkeypatch.setattr(families, "DIR", tmp_path)
    return tiny_cell(CELLS[0], family="dense_moe")


def test_parallel_keys_reach_the_program(monkeypatch, tmp_path):
    cell = _following(monkeypatch, tmp_path)
    cell["config"]["model"]["parallel"] = {"capacity_factor": 2.0, "moe_fallback": False}
    par = Program(cell, "cpu").model.cfg.parallel
    assert (par.capacity_factor, par.moe_fallback, par.remat) == (2.0, False, "block")


@pytest.mark.parametrize("key, value", [
    ("experts_per_chip", 8),             # no field of ParallelConfig
    ("remat", "none"),                   # the model group's own remat
    ("microbatches", 4),                 # the traffic's
    ("grad_accum_dtype", "bfloat16"),    # a precision under the reference's
    ("opt_state_dtype", "bfloat16"),
    ("pipeline_stages", 2),              # read by nothing
    ("grad_reduce", "all_reduce"),
    ("grad_compression", True),
    ("scan_layers", False),
    ("moe_dispatch", "local"),           # one the family's reference does not follow
])
def test_a_parallel_key_the_reference_does_not_follow_raises(monkeypatch, tmp_path, key, value):
    cell = _following(monkeypatch, tmp_path)
    cell["config"]["model"]["parallel"] = {"capacity_factor": 2.0, key: value}
    with pytest.raises(ValueError, match=key):
        Program(cell, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_family_that_follows_no_parallel_key_takes_none(name):
    cell = tiny_cell(name)
    cell["config"]["model"]["parallel"] = {"capacity_factor": 2.0}
    with pytest.raises(ValueError, match="capacity_factor"):
        Program(cell, "cpu")


@pytest.mark.parametrize("name, want", [
    ("train.stablelm-12b.s4096", ["flash_attention.backward_launches", "flash_attention.launches"]),
    ("train.stablelm-12b.s2048", ["flash_attention.backward_launches", "flash_attention.launches"]),
    ("train.mamba2-130m.s2048", ["causal_conv.backward_launches", "causal_conv.launches",
                                 "ssd_scan.backward_launches", "ssd_scan.launches"]),
])
def test_counters_are_the_readers_declarations(name, want):
    cell = load_cell(name)
    assert declared_counters(cell) == want
    assert all(isinstance(read_counter(c), int) for c in want)
    cell["per_layer"] = [m for m in cell["per_layer"] if "roofline" not in m["name"]]
    assert declared_counters(cell) == []


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reads_the_programs_spans(name):
    """A traced run on the CPU: the spans are on in its window only, and
    the metric that reads the host's spans reports (the CPU's trace holds
    no device operation, so those that read device time report nothing)."""
    from repro_torch import tracing

    result, lines = run(tiny_cell(name, "float32"), 2**31 + 43, 0.2, True, "cpu",
                        time.perf_counter(), log=lambda s: None)
    assert not tracing.enabled()
    assert result["correct"], lines
    assert result["metrics"]["update_host_ms.train"]["value"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}

"""The plain reference against the port's CPU path at tiny sizes, and the
comparison that decides ``correct`` failing the control and every fault.

On the CPU the port's K4 and K5 run their plain versions, so these tests
hold the reference's model, loss, gradients and AdamW to the port's
arithmetic; the card's kernels are held by the cells' runs."""

import json
import subprocess
import sys
import time

import pytest
import torch

from tiny import CELLS, ROOT, tiny_cell
from bench import check
from bench.faults import FAULTS
from bench.harness import Program, program_readings, reference_readings, run


def readings(prog, seed):
    _, mine = program_readings(prog, seed)
    return {k: v.float().tolist() for k, v in mine.items()}


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_port_in_float32(name):
    prog = Program(tiny_cell(name, "float32"), "cpu")
    values = check.numbers(readings(prog, 11), reference_readings(prog, 11))
    assert max(values.values()) < 1e-5, values


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, lines = run(tiny_cell(name, "float32"), 2**31 + 17, 0.2, False, "cpu",
                        time.perf_counter(), log=lambda s: None)
    assert result["correct"], lines
    assert list(result)[-1] == "checks" and result["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_separates(name):
    """The control (the reference with fp8 products) against the program at
    a size a test holds: on the number that fails it at the cell's size
    (``grad_gap``), every seed of the control reads 3 × the program's
    worst.  The cells' limits are set at their own sizes, where sound
    runs read other values; ``test_the_control_fails_at_the_cells_size``
    holds the control to them on the card."""
    prog = Program(tiny_cell(name), "cpu")
    sound, control = [], []
    for seed in (3, 4, 5):
        ref = reference_readings(prog, seed)
        sound.append(check.numbers(readings(prog, seed), ref)["grad_gap"])
        control.append(check.numbers(reference_readings(prog, seed, "fp8"), ref)["grad_gap"])
    assert min(control) >= 3 * max(sound), (sound, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name):
    """``calibrate.py`` on the card, in a process of its own (one process a
    card): on three seeds the program is correct and the control is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.harness import load_cell

    seeds = f"{2**31 + 5}-{2**31 + 7}"
    out = subprocess.run([sys.executable, "bench/calibrate.py", "--workload", name, "--seeds",
                          seeds, "--control", seeds], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = load_cell(name)["limits"]["limits"]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    verdicts = {(x["kind"], x["seed"]): check.verdict(x["numbers"], limits)
                for x in lines if "numbers" in x}
    assert sum(k == "control_fp8" for k, _ in verdicts) == 3
    assert all(ok == (kind == "program") for (kind, _), ok in verdicts.items()), verdicts


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    """A whole run (no card: the CPU), with the timed step broken underneath."""
    from repro_torch.launch.steps import TrainStep

    real = TrainStep.__call__
    monkeypatch.setattr(TrainStep, "__call__",
                        lambda self, *a: FAULTS[fault](lambda *b: real(self, *b))(*a))
    result, lines = run(tiny_cell(name), 2**31 + 29, 0.2, False, "cpu", time.perf_counter(),
                        log=lambda s: None)
    assert not result["correct"], lines

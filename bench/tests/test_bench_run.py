"""``run.py`` fails cleanly without a card and outside a checkout of the
program, and (on a card) runs a cell end to end."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_is_no_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no system to measure: the run fails before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from bench.harness import Program, load_cell\n"
            f"Program(load_cell({CELLS[0]!r}), 'cpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and "repro_torch" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                          str(2**31 + 101), "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"

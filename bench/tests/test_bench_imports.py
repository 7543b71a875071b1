"""The import guard: JAX and the JAX package are never loaded by a run,
compared by whole top-level name (the port's name begins with the JAX
package's), and the reference and the families import nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from tiny import ROOT
from bench.harness import BENCH, FORBIDDEN, forbidden_modules


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names_are_compared():
    names = ["jax", "jax.numpy", "repro", "repro.core.runtime", "repro_torch",
             "repro_torch.models", "jaxtyping", "flax.linen", "benchmarks.run", "benchmarks2"]
    assert forbidden_modules(names) == ["benchmarks", "flax", "jax", "repro"]
    assert forbidden_modules(["repro_torch", "repro_torch.launch.steps", "bench.harness"]) == []


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not [n for n in imports(path) if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py"))
                         + sorted((BENCH / "families").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not [n for n in imports(path) if n.split(".")[0] == "repro_torch"]


def test_a_run_loads_neither():
    """A tiny run on the CPU, in a process of its own: after its window the
    process holds no module of JAX or the JAX package."""
    code = ("import sys, time, tiny\n"
            "from bench.harness import run, forbidden_modules\n"
            "res, _ = run(tiny.tiny_cell(tiny.CELLS[0]), 7, 0.2, False, 'cpu', time.perf_counter(),"
            " log=lambda s: None)\n"
            "assert 'repro_torch' in sys.modules\n"
            "print('FOUND', forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH / "tests", env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout

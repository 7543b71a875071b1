"""The PyTorch port stands alone: no jax, nothing of ``repro``.

An AST scan finds every import in ``src/repro_torch`` and ``chip_smoke.py``,
and every string that names a jax or ``repro`` module as code would (an
entry string for ``python -c``, a module path), docstrings aside; a
subprocess in which ``import jax`` fails imports every module of the port
and runs its CPU entry points, a worker process and a checkpoint among
them; ``chip_smoke.py`` refuses to run, and prints no result, on a host
without a card.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def absolute_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = ("jax", "jaxlib", "repro")
# a whole string that is a module path, or an import statement anywhere in one
MODULE_PATH = re.compile(r"^(jax|jaxlib|repro)(\.\w+)*$")
IMPORT_STMT = re.compile(r"\b(from|import)\s+(jax|jaxlib|repro)\b(?!_)")


def code_strings(path):
    """String constants of ``path`` other than docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node.value


def names_forbidden_module(text):
    return bool(MODULE_PATH.match(text.strip()) or IMPORT_STMT.search(text))


def test_no_jax_or_reference_import():
    assert len(FILES) > 10, "the scan found too few files"
    offenders = [f"{path.relative_to(ROOT)} imports {name}"
                 for path in FILES for name in absolute_imports(path)
                 if name.split(".")[0] in FORBIDDEN]
    offenders += [f"{path.relative_to(ROOT)} names {text!r}"
                  for path in FILES for text in code_strings(path)
                  if names_forbidden_module(text)]
    assert not offenders, offenders


@pytest.mark.parametrize("text,flagged", [
    ("import sys; from repro.core.transport import _main; sys.exit(_main())", True),
    ("repro.core.transport", True),
    ("import jax.numpy as jnp", True),
    ("jax", True),
    ("import sys; from repro_torch.core.transport import _main", False),
    ("repro_torch.core.transport", False),
    ("the reference's ``repro.core.transport`` module", False),
    ("jax-free", False),
])
def test_string_scan_flags_entry_strings(text, flagged):
    assert names_forbidden_module(text) == flagged


def test_every_module_imports_and_runs_without_jax():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = f"""
import importlib, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
for name in {modules!r}:
    importlib.import_module(name)
import numpy as np, torch
from repro_torch.configs.paper_eneac import HotspotConfig
from repro_torch.kernels.hotspot.ops import hotspot, hotspot_hetero
from repro_torch.kernels.spmm.ops import make_hybrid_executor
from repro_torch.kernels.spmm.ref import make_problem, spmm_dense_ref
cfg = HotspotConfig(grid=32)
t = torch.full((32, 32), 80.0)
assert torch.equal(hotspot(t, torch.zeros_like(t), cfg, 2, mode="hpc"),
                   hotspot(t, torch.zeros_like(t), cfg, 2, mode="cc"))
hotspot_hetero(t, torch.zeros_like(t), cfg, 1, acc_chunk=8)
p = make_problem(24, 256, 8, seed=1)
ex, order = make_hybrid_executor(p, device="cpu")
res, _ = ex.run()
assert np.allclose(res.numpy()[np.argsort(order)], spmm_dense_ref(p), rtol=1e-4, atol=1e-4)
from repro_torch.launch import serve
for arch in ("tinyllama-1.1b", "mamba2-130m"):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "5"])
import tempfile
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import HeteroRuntime, FleetManager, spawn_worker
from repro_torch.core.transport import SleepWork
with tempfile.TemporaryDirectory() as d:
    Checkpointer(d).save(1, dict(w=torch.ones(3, dtype=torch.bfloat16)), blocking=True)
    assert Checkpointer(d).restore(1, dict(w=torch.ones(3)))[0]["w"].dtype == torch.bfloat16
rt = HeteroRuntime()
with FleetManager(rt, remote_backend="thread", spawn=lambda: spawn_worker(startup_timeout=120)) as fm:
    fm.scale_to(1)
    assert rt.parallel_for(SleepWork(0.0), num_items=32, acc_chunk=8).items == 32
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("PORT_OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "PORT_OK" in proc.stdout, proc.stderr


def test_chip_smoke_refuses_without_a_card():
    # it checks for a card before it imports the port, so here, without a
    # card, it fails at that check whether or not the port lies beside it
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr

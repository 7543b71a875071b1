"""The port's examples (``examples/torch_*.py``), each the counterpart of
the reference's example of the same name, run with ``--device cpu``.

Sizes: the SPMM demo at 128 of its 512 rows, the serving example with 6
of its 16 requests, the training example for 30 of its 300 steps (its
assertion, that the loss falls, holds there too); the quickstart and the
elastic demo at their own sizes.  Each asserts what its reference asserts
and returns what it printed.
"""

import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def example(name):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(f"torch_{name}")


def test_hetero_spmm_demo():
    out = example("hetero_spmm_demo").main(["--device", "cpu", "--rows", "128"])
    assert out["max_abs_err"] < 1e-3
    assert out["n_dense"] + out["n_sparse"] == 128


def test_quickstart():
    out = example("quickstart").main(["--device", "cpu"])
    assert out["items"] == 400 and out["elastic_covered"]
    assert torch.isfinite(torch.tensor(out["loss"])) and len(out["next_tokens"]) == 2


def test_serve_batched():
    reports = example("serve_batched").main(["--device", "cpu", "--requests", "6"])
    static, continuous = reports["static"], reports["continuous"]
    assert static["tokens"] == continuous["tokens"] > 0
    assert continuous["steps"] <= static["steps"]


def test_train_small(tmp_path):
    out = example("train_small").main(["--device", "cpu", "--steps", "30",
                                       "--ckpt-dir", str(tmp_path)])
    assert out["final_loss"] < out["first_loss"] and out["steps"] == 30


def test_elastic_sharded_demo():
    out = example("elastic_sharded_demo").main(["--device", "cpu"])
    assert out == {"sharded_exact_once": True, "elastic_exact_once": True, "tiles": 64}

"""Tiny cells for the CPU tests: a cell of BENCHMARK.json with its
configuration cut to its family's ``TINY`` sizes (``families/<family>.py``:
a few layers of narrow widths) and its traffic to a few short rows (the
card's cells keep their published widths)."""

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import families, harness  # noqa: E402
from bench.harness import load_cell  # noqa: E402

# the reference in blocks of 2 of the tiny rows (32 tokens x d_model 32), as
# the cells' references work in blocks
harness.REFERENCE_BLOCK_VALUES = 2 * 32 * 32

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_cell(name: str, dtype: str = "bfloat16", family: str = None) -> dict:
    """The cell ``name`` at its family's ``TINY`` sizes (``family``, when
    given, takes the place of its configuration's)."""
    cell = copy.deepcopy(load_cell(name))
    m = cell["config"]["model"]
    m["family"] = family or m["family"]
    m.update(families.load(m["family"]).TINY, vocab_size=200, dtype=dtype, param_dtype=dtype)
    cell["traffic"].update(global_batch=4, seq_len=32, loss_chunk=16, trace_steps=2,
                           microbatches=min(2, cell["traffic"]["microbatches"]))
    return cell

"""Tiny cells for the CPU tests: a cell of BENCHMARK.json with its
configuration cut to a few layers of narrow widths and its traffic to a
few short rows (the card's cells keep their published widths)."""

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402
from bench.harness import load_cell  # noqa: E402

# the reference in blocks of 2 of the tiny rows (32 tokens x d_model 32), as
# the cells' references work in blocks
harness.REFERENCE_BLOCK_VALUES = 2 * 32 * 32

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SIZES = {"dense": dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64),
         "ssm": dict(num_layers=2, d_model=32, ssm_state=16, ssm_head_dim=8, ssm_chunk=8)}


def tiny_cell(name: str, dtype: str = "bfloat16") -> dict:
    cell = copy.deepcopy(load_cell(name))
    m = cell["config"]["model"]
    m.update(SIZES[m["family"]], vocab_size=200, dtype=dtype, param_dtype=dtype)
    cell["traffic"].update(global_batch=4, seq_len=32, loss_chunk=16, trace_steps=2,
                           microbatches=min(2, cell["traffic"]["microbatches"]))
    return cell

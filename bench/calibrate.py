"""The readings that a cell's limits are set from, on the chip.

    python3 bench/calibrate.py --workload <cell> --seeds 1-12 --control 1-3 --faults 1-3

For each seed, in one process: the program's first steps at the cell's
own size (``harness.program_readings``) against the float32 reference's
(the sound readings); on the ``--control`` seeds, the control (the
reference with fp8 products, ``reference/precision.py``) against the
same reference; on the ``--faults`` seeds, the program with each fault
of ``faults.py`` planted under its step.  One JSON line a reading:
{"seed", "kind", "numbers": {name: value}, "seconds"}.  The benchmark's
own runs never run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--faults", type=seeds, default=[])
    args = ap.parse_args(argv)

    import torch

    from bench import check
    from bench.faults import FAULTS
    from bench.harness import Program, load_cell, program_readings, reference_readings

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    prog = Program(load_cell(args.workload), "cuda")
    real = prog.step

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def emit(seed, kind, readings, ref, t0):
        worst = {"grad_gap": check.worst_leaf(readings["grads"], ref["grads"])[1],
                 "change_gap": check.worst_leaf(readings["changes"], ref["changes"],
                                                check.kept(ref))[1]}
        line = {"seed": seed, "kind": kind, "numbers": check.numbers(readings, ref),
                "worst": {k: "/".join(map(str, prog.paths[i])) for k, i in worst.items()},
                "excluded": ["/".join(map(str, p)) for p, k in zip(prog.paths, check.kept(ref))
                             if not k],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)

    def program(seed, fault=None):
        prog.step = real if fault is None else FAULTS[fault](real)
        state, mine = program_readings(prog, seed)
        mine = {k: v.float().cpu().tolist() for k, v in mine.items()}
        del state
        free()
        return mine

    for seed in args.seeds:
        t0 = time.perf_counter()
        mine = program(seed)
        t1 = time.perf_counter()
        ref = reference_readings(prog, seed)
        free()
        emit(seed, "program", mine, ref, t0)
        print(json.dumps({"seed": seed, "kind": "reference_seconds",
                          "seconds": time.perf_counter() - t1,
                          "losses": ref["losses"]}), flush=True)
        if seed in args.control:
            t0 = time.perf_counter()
            emit(seed, "control_fp8", reference_readings(prog, seed, "fp8"), ref, t0)
            free()
        if seed in args.faults:
            for fault in FAULTS:
                t0 = time.perf_counter()
                emit(seed, fault, program(seed, fault), ref, t0)
    print(json.dumps({"kind": "done", "seconds": time.perf_counter() - STARTED,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's result as the last line of
standard output (one JSON object) and each number that decides
``correct`` beside its limit as the last lines of standard error.  Exits
with another code than 0, and prints no result, when no CUDA card (or
fewer than the cell asks for) is present, or when JAX or the JAX package
is loaded once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches of PyTorch and the CUDA driver at fixed paths inside the checkout
# (the program's own nvcc libraries go to build/repro_torch/)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "bench" / "torch-kernels")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "bench" / "cuda-cache")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import Forbidden, load_cell, run

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED,
                            log=lambda s: print(f"bench: {s}", file=sys.stderr, flush=True))
    except Forbidden as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

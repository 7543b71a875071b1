"""The perf cells on the dry-run: hypothesis → change → re-run → priced.

The port's counterpart of ``repro.launch.perf``: tagged dry-run variants
(``launch/dryrun.py``) of three production cells on the 16×16 mesh, with
the reference's overrides, and the roofline terms of each.  Every number
is a prediction from the H100 SXM data sheet's rates.

Cells:
  A. stablelm-12b × train_4k      — a dense trainer: sequence parallelism,
                                    then SP + ``replicate_kv``
  B. llama3.2-3b × prefill_32k    — ``replicate_kv``, then ``replicate_kv``
                                    + SP (its 24 query heads are cut on 16
                                    model ranks)
  C. qwen3-moe-30b-a3b × train_4k — ENEAC's MoE dispatch: ``gspmd`` and
                                    ``local``, ``capacity_factor`` 1.0,
                                    and no fallback (overflow dropped)

:func:`flash_substitution` is the difference between a ``plain=True``
dry-run of a cell as configured, which prices the attention interior op
by op (forward, and autograd's backward in a training cell), and the
default one, which prices K4's forward by its ``kernel_hbm_bytes`` and
its backward by its backward kernels' ``backward_hbm_bytes``, what the
card runs.

The variants are independent one-rank traces, so :func:`run_cells` runs
them in ``workers`` processes at once.

``python -m repro_torch.launch.perf [--cell A|B|C] [--workers N]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..configs import get_config
from .dryrun import BASIS, DEFAULT_OUT, run_cell
from .mesh import H100_SXM

__all__ = ["CELLS", "flash_substitution", "run_cells", "show", "main"]

# cell: (arch, shape, [(label, tag, ParallelConfig overrides)], flash substitution)
CELLS = {
    "A": ("stablelm-12b", "train_4k", [
        ("baseline", "perf-baseline", {}),
        ("+sequence-parallel", "perf-sp", {"sequence_parallel": True}),
        ("+replicate-kv", "perf-sp-kvrep", {"sequence_parallel": True, "replicate_kv": True}),
    ], True),
    "B": ("llama3.2-3b", "prefill_32k", [
        ("baseline", "perf-baseline", {}),
        ("+replicate-kv", "perf-kvrep", {"replicate_kv": True}),
        ("+sequence-parallel", "perf-kvrep-sp", {"replicate_kv": True,
                                                 "sequence_parallel": True}),
    ], True),
    "C": ("qwen3-moe-30b-a3b", "train_4k", [
        ("baseline (gspmd dispatch)", "perf-gspmd", {"moe_dispatch": "gspmd"}),
        ("+local dispatch", "perf-local", {}),
        ("+capacity-factor 1.0", "perf-cap1.0", {"capacity_factor": 1.0}),
        ("drop-overflow (no ENEAC CC)", "perf-nofallback", {"moe_fallback": False}),
    ], False),
}


def flash_substitution(rec: dict, plain: dict) -> dict:
    """What K4 (its forward, and its backward in a training cell) saves over
    its plain version in one cell: the two dry-runs' HBM bytes and memory
    terms (``rec`` the default run, ``plain`` the ``plain=True`` one)."""
    kernel = rec["ops"]["kernels"].get("flash_attention", {})
    backward = rec["ops"]["kernels"].get("flash_attention_backward", {})
    return {
        "plain_hbm_bytes": plain["ops"]["hbm_bytes"],
        "kernel_hbm_bytes": rec["ops"]["hbm_bytes"],
        "attention_interior_bytes": plain["ops"]["hbm_bytes"] - rec["ops"]["hbm_bytes"],
        "k4_forward_bytes": kernel.get("hbm_bytes", 0.0),
        "k4_calls": kernel.get("calls", 0),
        "k4_backward_bytes": backward.get("hbm_bytes", 0.0),
        "k4_backward_calls": backward.get("calls", 0),
        "memory_s_plain": plain["roofline"]["memory_s"],
        "memory_s_kernel": rec["roofline"]["memory_s"],
        "hbm_bw": H100_SXM.hbm_bw,
        "basis": BASIS,
    }


def show(label: str, rec: dict) -> None:
    r, m = rec["roofline"], rec["memory"]
    print(f"  {label:30s} c/m/x = {r['compute_s']:8.3f}/{r['memory_s']:8.3f}/"
          f"{r['collective_s']:8.3f} s  dom={r['dominant']:10s} "
          f"peak={m['peak_est_bytes'] / 2**30:6.1f}GiB "
          f"({'fits' if m['fits'] else 'OVER-HBM'}) useful={r['useful_flops_ratio']:.3f}")


def _job(arch: str, shape: str, tag: str, overrides: dict, plain: bool, out: str) -> dict:
    cfg = get_config(arch)
    kw = {"parallel": dataclasses.replace(cfg.parallel, **overrides)} if overrides else None
    return run_cell(arch, shape, False, Path(out), overrides=kw, tag=tag, plain=plain)


def run_cells(names: Sequence[str], out: Path, workers: Optional[int] = None
              ) -> Dict[str, dict]:
    """Every variant of the cells ``names`` (and each substitution's plain
    run), traced in ``workers`` processes (default: one a core); prints each
    cell's lines and writes ``perf_cell<X>_flashsub.json`` under ``out``.
    Returns {cell: {tag: record, "flash_substitution": ...}}."""
    jobs: List[tuple] = []
    for name in names:
        arch, shape, variants, sub = CELLS[name]
        jobs += [(name, arch, shape, tag, over, False) for _, tag, over in variants]
        if sub:
            jobs.append((name, arch, shape, variants[0][1] + "-plain", variants[0][2], True))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        # the longest traces (training cells) first
        order = sorted(range(len(jobs)), key=lambda i: jobs[i][2] != "train_4k")
        futures = {i: pool.submit(_job, *jobs[i][1:], str(out)) for i in order}
        recs = [futures[i].result() for i in range(len(jobs))]
    done: Dict[str, dict] = {}
    for name in names:
        arch, shape, variants, sub = CELLS[name]
        print(f"=== Cell {name}: {arch} × {shape} (predicted: {BASIS})")
        mine = {j[3]: rec for j, rec in zip(jobs, recs) if j[0] == name}
        for label, tag, _ in variants:
            show(label, mine[tag])
        done[name] = dict(mine)
        if sub:
            base = variants[0][1]
            s = flash_substitution(mine[base], mine[base + "-plain"])
            print(f"  flash substitution ({base})  m = {s['memory_s_plain']:.3f}s plain → "
                  f"{s['memory_s_kernel']:.3f}s through K4 (interior "
                  f"{s['attention_interior_bytes'] / 1e12:.3f} TB)")
            out.mkdir(parents=True, exist_ok=True)
            (out / f"perf_cell{name}_flashsub.json").write_text(json.dumps(s, indent=1))
            done[name]["flash_substitution"] = s
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=tuple(CELLS), default=None)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--workers", type=int, default=None,
                    help="processes to trace in (default: one a core)")
    args = ap.parse_args(argv)
    run_cells([k for k in CELLS if args.cell in (None, k)], args.out, args.workers)


if __name__ == "__main__":
    main()

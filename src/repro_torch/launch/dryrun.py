"""Multi-pod dry-run: one rank's step of every (arch × shape × mesh) cell, on
``meta`` tensors, priced.

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers
and compiles each cell on 512 placeholder host devices; no host can spawn
256 ranks of PyTorch, so the port runs **one rank's real step on ``meta``
tensors** over **shape-only groups** of the production mesh's sizes
(:class:`~repro_torch.parallel.collectives.ShapeGroup`): nothing is
allocated, no card is needed, and each collective counts the bytes it
would hand and moves nothing.  Meta tensors never compute, and a
shape-only group raises on any tensor that is not on ``meta``.

Per cell this driver:

1. takes ``cell_status`` and ``SHAPES`` from the port's configs (a
   skipped cell is written with its reason);
2. builds the production mesh as a rank-free ``MeshShape``
   (``launch/mesh.py``: 16×16, or 2×16×16 with ``--multi-pod``) and the
   rules over it; rank 0's coordinate stands for every rank;
3. builds one rank's train, prefill or decode step with
   ``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` on a
   model on ``meta``: the rank's blocks of ``abstract_params()``
   (``step.shard``), ``AdamW.abstract_state`` of them, ``input_specs``,
   and for decode the rank's caches (its rows, its kv heads);
4. runs the step once under ``launch/op_analysis.analyze_step``;
5. records per-rank parameter, moment, batch and cache bytes and the peak
   estimate against ``H100_SXM.hbm_bytes``; the dot FLOPs, HBM bytes and
   collective bytes by kind and by group; the three roofline terms —
   compute on the peak rate of the model's dtype, memory on ``hbm_bw``,
   each group's collective bytes on the slowest link it crosses — and
   ``model_flops`` with ``useful_flops_ratio``;
6. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.
   Every number in it is a prediction from data-sheet constants
   (``"basis"``).

**Stand-ins** (:data:`STAND_INS`): meta tensors hold no values, so
wherever a value is read a stand-in that leaves shapes and bytes as a
real step's takes its place.  The steps themselves read none: no
``.item()``, no host branch on a tensor.

**Shapes that depend on data.**  The MoE capacity plan and ENEAC's dense
fallback have static shapes in the port as in the reference: each expert
takes its capacity of slots and the fallback FFN runs over every token,
so the cell prices the static bound the reference's ``jit`` compiles.

**Microbatches.**  A training step's microbatches are identical pieces:
the first runs once, and the second runs under the analysis's
``repeat(microbatches - 1)`` for every one after it (``TrainStep.pieces``);
``tests/test_torch_dryrun.py`` holds that shortcut to the full trace.

Usage::

  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..configs import ARCH_NAMES, SHAPES, InputShape, cell_status, get_config
from ..configs.base import ModelConfig
from ..models import make_model
from ..optim import AdamW
from ..parallel.mesh_rules import DATA_AXES, MeshRules, MeshShape
from .mesh import H100_SXM, HardwareSpec, make_production_mesh
from .op_analysis import OpAnalysis, analyze_step
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["DEFAULT_OUT", "BASIS", "STAND_INS", "dry_run", "run_cell", "summary", "main"]

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
BASIS = "NVIDIA H100 SXM data sheet"

STAND_INS = {
    "all_reduce_float": "a shape-only group's reduction of a host number returns size x the "
                        "rank's number for a sum and the number for a max (every rank stands "
                        "for rank 0); its 8 bytes are counted as the real one's",
    "item": "none needed: the steps read no value on the host (no .item(), no float() of a "
            "tensor); the loop's float(loss) and timing reductions are outside the step",
    "clip": "the clipping factor is a meta tensor: every gradient is scaled by it, as a real "
            "step scales them whether or not the norm exceeds the limit",
    "argmax": "the decode step's tokens are meta inputs of (B, 1): the caller's greedy argmax "
              "over the model group (models.greedy_tokens) lies outside the step",
    "moe_routing": "the router's top-k is a meta tensor: the capacity plan is (experts, "
                   "capacity) whatever the routing, and the fallback FFN runs on every token",
}


def _bytes(tree) -> int:
    """The bytes of a tree's tensors (the caches' dataclasses included)."""
    if dataclasses.is_dataclass(tree):
        return sum(_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(map(_bytes, tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(map(_bytes, tree))
    return 0


def _opt_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.parallel.opt_state_dtype == "bfloat16" else torch.float32


def dry_run(cfg: ModelConfig, shape: InputShape, mesh: MeshShape, *,
            hw: HardwareSpec = H100_SXM, plain: bool = False, prompt: Optional[int] = None,
            microbatches: Optional[int] = None, loss_chunk: int = 1024,
            shortcut: bool = True) -> Dict[str, Any]:
    """One rank's step of ``cfg`` for ``shape`` on ``mesh`` (a ``MeshShape``),
    run once on meta tensors and priced: the record's memory, op report,
    per-group collective bytes and roofline.  ``prompt``: a prefill's
    token count (default ``shape.seq_len``, the caches' length);
    ``plain``: K4 and K5 through their plain versions, op by op;
    ``shortcut=False`` traces every microbatch."""
    model = make_model(cfg, device="meta", plain=plain)
    rules = MeshRules(mesh, cfg.parallel)
    n_dev = math.prod(mesh.shape)
    analysis = OpAnalysis()
    specs = model.input_specs(shape)
    memory: Dict[str, int] = {}
    if shape.kind == "train":
        opt = AdamW(cfg=cfg, state_dtype=_opt_dtype(cfg))
        step = make_train_step(model, opt, rules, shape, microbatches=microbatches,
                               loss_chunk=loss_chunk)
        if shortcut and step.microbatches > 1:
            def pieces(mb=step.microbatches):
                yield 0
                with analysis.repeat(mb - 1):
                    yield 1
            step.pieces = pieces
        shards = step.shard(model.abstract_params())
        state = opt.abstract_state(shards)
        batch = specs["batch"]
        memory.update(param_bytes=_bytes(shards), opt_state_bytes=_bytes(state))
        args = (shards, state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(model, rules, shape)
        shards = step.shard(model.abstract_params())
        batch = dict(specs["batch"])
        if prompt is not None:
            batch["tokens"] = torch.empty((shape.global_batch, prompt), dtype=torch.int32,
                                          device="meta")
        memory.update(param_bytes=_bytes(shards))
        args = (shards, batch)
    else:
        step = make_decode_step(model, rules, shape)
        shards = step.shard(model.abstract_params())
        batch = {"tokens": specs["tokens"], "positions": specs["positions"]}
        rows = batch["tokens"].shape[0] if step.tp is None else \
            step.local_batch(batch)["tokens"].shape[0]
        caches = model.init_caches(rows, shape.seq_len, tp=step.tp)
        memory.update(param_bytes=_bytes(shards), cache_bytes=_bytes(caches))
        args = (shards, batch["tokens"], batch["positions"], caches)
    local = batch if step.tp is None else step.local_batch(batch)
    memory["batch_bytes"] = _bytes(local)
    t0 = time.perf_counter()
    report = analyze_step(step, *args, analysis=analysis)
    trace_s = time.perf_counter() - t0
    argument = sum(memory.values())
    # the port's step is handed the global batch: its extra rows count in the peak
    peak = argument + report.temp_peak_bytes + _bytes(batch) - memory["batch_bytes"]
    memory.update(argument_bytes=argument, temp_peak_bytes=report.temp_peak_bytes,
                  peak_est_bytes=peak, hbm_capacity=int(hw.hbm_bytes),
                  fits=bool(peak < hw.hbm_bytes))

    names = mesh.mesh_dim_names
    group_axes = {"model": ["model"], "data": [a for a in names if a in DATA_AXES],
                  "world": list(names)}
    rates = {g: hw.group_rate(mesh.shape, names, axes) for g, axes in group_axes.items()}
    by_group = {g: float(sum(report.collective_by_group.get(g, {}).values()))
                for g in group_axes}
    f32 = cfg.dtype == "float32"
    compute_s = report.dot_flops / (hw.f32_flops if f32 else hw.peak_flops)
    memory_s = report.hbm_bytes / hw.hbm_bw
    collective_s = sum(b / rates[g] for g, b in by_group.items() if b)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    model_fl = model.model_flops(shape if prompt is None else
                                 InputShape(shape.name, prompt, shape.global_batch, shape.kind))
    rep = report.as_dict()
    return dict(
        n_devices=n_dev,
        trace_s=trace_s,
        microbatches=getattr(step, "microbatches", 1),
        basis=BASIS,
        memory=memory,
        ops={k: rep[k] for k in ("dot_flops", "hbm_bytes", "collective_bytes",
                                 "collective_by_kind", "collective_count", "collective_by_group",
                                 "top_collectives", "top_traffic", "trip_counts", "kernels",
                                 "ops")},
        collective_bytes_by_group=by_group,
        link_rates=rates,
        notes=rep["notes"] + [f"stand-in for {k}: {v}" for k, v in STAND_INS.items()] + [
            "MoE: the capacity plan and the fallback FFN are priced at their static bound, the "
            "capacity the reference's jit compiles",
            "collectives: each group's bytes over the slowest link it crosses (8 GPUs a node "
            "on NVLink, NDR InfiniBand between nodes)",
            f"compute: dot FLOPs over the {'float32' if f32 else 'bf16'} peak"],
        roofline=dict(
            compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
            dominant=max(terms, key=terms.get), bound_s=max(terms.values()),
            model_flops=model_fl,
            useful_flops_ratio=model_fl / max(report.dot_flops * n_dev, 1.0)),
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, *,
             overrides=None, tag: str = "", plain: bool = False) -> dict:
    """One production cell: dry-run and write its record (or its skip)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    runnable, reason = cell_status(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag, "status": "skip",
           "reason": reason, "basis": BASIS}
    if runnable:
        rec.update(dry_run(cfg, shape, make_production_mesh(multi_pod=multi_pod), plain=plain),
                   status="ok", plain=plain)
    _write(out_dir, cell_id, rec)
    return rec


def _write(out_dir: Path, cell_id: str, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{cell_id}.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    records = []
    for a, s, mp in cells:
        label = f"{a} × {s} × {'2x16x16' if mp else '16x16'}"
        try:
            rec = run_cell(a, s, mp, args.out)
            records.append(rec)
            if rec["status"] == "skip":
                print(f"SKIP {label}: {rec['reason']}")
                continue
            r, m = rec["roofline"], rec["memory"]
            print(f"OK   {label}: traced {rec['trace_s']:.1f}s, "
                  f"peak {m['peak_est_bytes'] / 2**30:.1f}GiB "
                  f"({'fits' if m['fits'] else 'OVER-HBM'}), "
                  f"terms c/m/x = {r['compute_s']:.3f}/{r['memory_s']:.3f}/"
                  f"{r['collective_s']:.3f}s → {r['dominant']} (predicted: {BASIS})")
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures += 1
            print(f"FAIL {label}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    print(f"\n{len(cells) - failures}/{len(cells)} cells passed")
    for line in summary(records):
        print(line)
    return 1 if failures else 0


def summary(records) -> list:
    """Per mesh: the cells run and skipped, those whose peak estimate
    exceeds the card's memory, and how many each roofline term dominates."""
    lines = []
    for mesh in sorted({r["mesh"] for r in records}):
        mine = [r for r in records if r["mesh"] == mesh]
        ran = [r for r in mine if r["status"] == "ok"]
        over = [f"{r['arch']} × {r['shape']}" for r in ran if not r["memory"]["fits"]]
        dominant = {}
        for r in ran:
            dominant[r["roofline"]["dominant"]] = dominant.get(r["roofline"]["dominant"], 0) + 1
        lines.append(f"{mesh}: {len(ran)} run, {len(mine) - len(ran)} skipped; over "
                     f"{H100_SXM.hbm_bytes / 1e9:.0f} GB a rank: {over or 'none'}; dominant: "
                     f"{dominant} (predicted: {BASIS})")
    return lines


if __name__ == "__main__":
    raise SystemExit(main())

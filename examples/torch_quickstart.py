"""Quickstart on the PyTorch port: the public API in 60 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    ElasticSchedule,
    HeteroRuntime,
    ShardedSpace,
    SimulatedClock,
    TiledSpace,
    WorkerKind,
)
from repro_torch.models import make_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = {}

    # ------------------------------------------------------------ models --
    # Any assigned architecture by id; .smoke() gives a CPU-runnable reduction.
    cfg = get_config("qwen3-14b").smoke()
    model = make_model(cfg, device=args.device)
    params = model.init(0)

    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           dtype=torch.int32).to(args.device)
    loss, metrics = model.loss_fn(
        params, {"tokens": tokens, "labels": tokens,
                 "mask": torch.ones(tokens.shape, dtype=torch.float32, device=args.device)})
    out["loss"] = float(loss)
    print(f"[models]   {cfg.name}: loss={out['loss']:.4f}")

    # generation: prefill + decode with a KV cache
    logits, caches = model.prefill(params, tokens, max_len=24)
    nxt = logits.argmax(-1)[:, None].int()
    logits, caches = model.decode_step(
        params, nxt, torch.full((2, 1), 16, dtype=torch.int32, device=args.device), caches)
    out["next_tokens"] = logits.argmax(-1).tolist()
    print(f"[serving]  decoded next tokens: {out['next_tokens']}")

    # ------------------------------------------------------------ runtime --
    # The paper's pipeline behind one call: register heterogeneous units, then
    # HeteroRuntime.parallel_for runs the iteration space under a pluggable
    # scheduling policy (multidynamic / static / oracle) and completion engine
    # (interrupt / polling / inline).  Real execution uses per-unit work_fns:
    rt = HeteroRuntime()
    for i in range(2):
        rt.register_unit(f"acc{i}", WorkerKind.ACC,
                         work_fn=lambda c: time.sleep(c.size / 8e4))
        rt.register_unit(f"cc{i}", WorkerKind.CC,
                         work_fn=lambda c: time.sleep(c.size / 1e4))
    report = rt.parallel_for(num_items=400, policy="multidynamic",
                             engine="interrupt", acc_chunk=64)
    out["items"] = report.items
    print(f"[eneac]    {report.items} items, split={report.per_worker_items}, "
          f"load-balance={report.load_balance:.2f}")

    # Under SimulatedClock the same run is virtual-time: unit `speed` priors
    # (items/s) replace work_fns, nothing sleeps, and makespan / utilization /
    # coverage are exactly reproducible.
    sim = HeteroRuntime(clock=SimulatedClock())
    for i in range(2):
        sim.register_unit(f"acc{i}", WorkerKind.ACC, speed=8e4)
        sim.register_unit(f"cc{i}", WorkerKind.CC, speed=1e4)
    vrep = sim.parallel_for(num_items=4000, policy="multidynamic",
                            engine="interrupt", acc_chunk=256)
    util = {k: f"{v:.2f}" for k, v in vrep.utilization.items()}
    print(f"[virtual]  makespan={vrep.makespan * 1e3:.2f}ms (virtual), "
          f"utilization={util}")

    # ------------------------------------------------------------- spaces --
    srep = sim.parallel_for(space=ShardedSpace(8000, num_shards=2),
                            policy="multidynamic", engine="interrupt",
                            acc_chunk=256)
    print(f"[sharded]  {srep.num_shards} shards, items={srep.items}, "
          f"cross-shard balance={srep.cross_shard_balance:.3f}")

    tiles = TiledSpace(grid=(512, 512), tile=(128, 128))   # 4x4 = 16 tiles
    trep = sim.parallel_for(space=tiles, policy="multidynamic",
                            engine="interrupt", acc_chunk=4)
    print(f"[tiled]    {tiles.describe()}: {trep.items} tiles scheduled")

    # ------------------------------------------------------------ elastic --
    # Units may join/leave mid-run (SimulatedClock): a departing unit's
    # in-flight chunk is requeued to the survivors.
    events = ElasticSchedule().leave(0.01, "cc0").join(0.015, "cc2", kind="cc",
                                                       speed=2e4)
    erep = sim.parallel_for(num_items=4000, policy="multidynamic",
                            engine="interrupt", acc_chunk=256, elastic=events)
    out["elastic_covered"] = erep.coverage[0][0] == 0 and erep.coverage[-1][1] == 4000
    print(f"[elastic]  coverage intact={out['elastic_covered']}, "
          f"events={[(e['action'], e['unit']) for e in erep.events]}")
    return out


if __name__ == "__main__":
    main()

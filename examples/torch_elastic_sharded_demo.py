"""Sharded + elastic iteration spaces on the PyTorch port, end to end.

    PYTHONPATH=src python examples/torch_elastic_sharded_demo.py

Three escalating scenarios, all in deterministic virtual time
(SimulatedClock — nothing sleeps, every run is exactly reproducible):

1. A global space sharded across hosts, each host running its own
   MultiDynamic scheduler + interrupt engine over its slice.
2. A mid-run host failure driven through ElasticMeshManager: the mesh's
   failure domain maps to scheduler units, the departed unit's in-flight
   chunk is requeued, and a replacement unit joins and starts stealing.
3. A 2D tiled kernel grid (hotspot-style) scheduled as tiles.

The units are virtual (their speeds are priors), so nothing runs on a
device; ``--device`` is taken for a command line like the other examples'.
"""

import argparse

import numpy as np

from repro_torch.core import (
    ElasticMeshManager,
    ElasticSchedule,
    HeteroRuntime,
    ShardedSpace,
    SimulatedClock,
    TiledSpace,
    WorkerKind,
)


def make_host(clock):
    """One SoC's worth of units: 2 fast ACCs + 2 slow CCs."""
    rt = HeteroRuntime(clock=clock)
    for i in range(2):
        rt.register_unit(f"acc{i}", WorkerKind.ACC, speed=8e4)
        rt.register_unit(f"cc{i}", WorkerKind.CC, speed=1e4)
    return rt


def exact_once(coverage, n):
    ok = coverage[0][0] == 0 and coverage[-1][1] == n
    return ok and all(b == c for (_, b), (c, _) in zip(coverage, coverage[1:]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="accepted; nothing runs on a device")
    ap.parse_args(argv)
    # -- 1. sharded ------------------------------------------------------------
    rng = np.random.default_rng(0)
    costs = rng.zipf(1.5, 16384).clip(max=50).astype(float)   # irregular workload

    rt = make_host(SimulatedClock())
    rep = rt.parallel_for(
        space=ShardedSpace(16384, num_shards=4),
        policy="multidynamic", engine="interrupt", acc_chunk=256,
        item_cost=costs,
    )
    out = {"sharded_exact_once": exact_once(rep.coverage, 16384)}
    print(f"[sharded]  {rep.num_shards} shards x {len(rt.units)} units, "
          f"items={rep.items}, exact-once={exact_once(rep.coverage, 16384)}")
    print(f"           makespan={rep.makespan * 1e3:.2f}ms virtual, "
          f"cross-shard balance={rep.cross_shard_balance:.3f}, "
          f"intra-shard load balance={rep.load_balance:.3f}")

    # -- 2. elastic, mesh-driven -----------------------------------------------
    # Two hosts of 4 devices each; units are bound to hosts so a device fault
    # (which takes out its whole host) becomes unit-leave events for the run.
    mesh = ElasticMeshManager((2, 4), ("host", "model"), host_size=4)
    schedule = ElasticSchedule.from_mesh(
        mesh,
        bindings={"acc1": 1, "cc1": 1},        # these units live on host 1
        faults=[(0.02, 5)],                    # device 5 fails at t=0.02
        joins=[],
    )
    schedule.join(0.05, "acc9", kind="acc", speed=8e4)   # replacement capacity

    rt = make_host(SimulatedClock())
    rep = rt.parallel_for(
        num_items=16384, policy="multidynamic", engine="interrupt",
        acc_chunk=256, item_cost=costs, elastic=schedule,
    )
    out["elastic_exact_once"] = exact_once(rep.coverage, 16384)
    print(f"[elastic]  exact-once={exact_once(rep.coverage, 16384)}, "
          f"mesh lost devices={mesh.lost_ids}")
    for ev in rep.events:
        req = f", requeued {ev['requeued']}" if ev["requeued"] else ""
        print(f"           t={ev['t']:.3f}s {ev['action']:>5} {ev['unit']}{req}")
    print(f"           replacement did {rep.per_worker_items.get('acc9', 0)} items")

    # -- 3. tiled 2D kernel grid ----------------------------------------------
    space = TiledSpace(grid=(1024, 1024), tile=(128, 128))   # 8x8 tiles
    touched = []
    rt = make_host(SimulatedClock())
    rep = rt.parallel_for(
        lambda chunk: touched.extend(space.chunk_slices(chunk)),
        space=space, policy="multidynamic", engine="interrupt", acc_chunk=8,
    )
    print(f"[tiled]    {space.describe()}: {rep.items} tiles, "
          f"{len(touched)} slices recorded, "
          f"first={touched[0][0]}, {touched[0][1]}")
    return dict(out, tiles=len(touched))


if __name__ == "__main__":
    main()

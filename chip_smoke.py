#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when a check fails:

1. Build the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, all
   started together).  Check each kernel against its plain PyTorch version
   on the card at the paper's sizes and time both: K1 (HOTSPOT 2048², 8
   steps in one launch; and the runtime's band, 130 × 2048 with steps=1)
   bitwise, and K2 (2048², 8 launches) at rtol 1e-5, atol 1e-4;
   K3 on the full SPMM problem (29957 × 29957 · 29957 × 100, seed 1234)
   bitwise and at 1e-4, with ``torch.sparse.mm`` on the same matrix in CSR
   timed beside it; K3's bound counts the bytes it must move and the flops
   of the nonzero entries (2 · nnz · N).
2. SPMM hybrid: ``make_hybrid_executor`` splits the density-sorted rows
   between K3 on the card and the gather path on host cores;
   ``converge(rounds=5)`` then ``run()``, compared with K3's plain result.
3. HOTSPOT through ``HeteroRuntime``: Table-1 configurations 5
   (4CC+4HPACC+INT, K2) and 7 (4CC+4HPCACC+INT, K1 with steps=1), one
   ``parallel_for`` per time step for 8 steps, compared with the whole-grid
   plain ``hotspot_ref`` on the card; every step must cover each row once.

4. K4 (flash attention) and K5 (SSD scan) at the full-width shapes of the
   serving path, each against its plain version: K4 at tinyllama-1.1b's
   prefill attention (B 1, S 2048, 1000 and the longest served prompt's
   891, whose 7128 rows leave a ragged last tile, H 32, KVH 4, D 64,
   causal) in bf16 (2e-2) and f32 (rtol 2e-4, atol 2e-5) against both its
   plain version and the ``mha_ref`` oracle, with
   ``scaled_dot_product_attention`` timed beside it (each row prints
   kernel ms over SDPA ms); K5 at mamba2-130m's
   prefill (B 1, S 2048, 1000 and the longest served prompt's 891, H 24,
   P 64, N 128, chunk 256) with zero and nonzero h0 at 2e-4.
5. Serving at full width: tinyllama-1.1b (K4) and mamba2-130m (K5), random
   bf16 weights from a seeded generator on the card, 8 requests through
   ``ServingEngine`` (4 slots, continuous, inline, greedy, max_len 2048).
   Every request completes, the RunReport covers each exactly once, the
   kernel launches equal layers × prefills, and a float32 copy of each
   model gives the same greedy tokens through the kernels as through their
   plain versions, with last-position logits within rtol/atol 1e-3.
   Prints TTFT, prefill and decode times, tokens/s and a profiler top-10
   of one prefill and one decode step.

Launch counts are set to 0 just before each main path (phases 2–3 for
K1–K3, each model's serving run in phase 5) and read just after, so they
count the main path's launches only.  The last lines are a JSON line of
the kernels' numbers and the JSON result line.

Kernel times: ``ms``, ``plain_ms`` and ``library_ms`` are CUDA events
around one call on an idle card, so a call that the host enqueues more
slowly than the card runs it is timed with its enqueue, as a caller sees
it; ``device_ms`` holds the stream while the host enqueues and times the
card's work alone.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Published peaks of one H100 SXM (dense, at its 700 W limit): device
# memory rate, f32 rate outside the tensor cores, bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# flops of one stencil update of one cell (_step_math: 10 adds/subs, 5 muls)
STENCIL_FLOPS = 15

HOTSPOT_TOL = dict(rtol=1e-5, atol=1e-4)
SPMM_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_ARCHS = ("tinyllama-1.1b", "mamba2-130m")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, *, reps: int = 10, warmup: int = 2, hold: bool = False) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events.

    The card is idle when each timed call starts, so the events bracket the
    host's enqueue too wherever the card would wait for it.  With ``hold``
    a spin kernel first holds the stream for twice the host's time to
    enqueue ``fn`` (at most 50 ms), and the events bracket the card's work
    alone: a kernel of a few microseconds is timed as it runs, not as fast
    as Python can launch it.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 0
    if hold:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin = int(min(2.0 * host_ms + 0.05, 50.0) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(least milliseconds, "bytes" or "operations") on the published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, tol: dict) -> float:
    import torch

    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(torch.allclose(got, want, **tol), f"{name}: max |err| {err} beyond {tol}")
    print(f"{name}: max_abs_err={err:.3e} within rtol={tol['rtol']} atol={tol['atol']}")
    return err


def phase1_kernels(cfg, spmm_cfg):
    import numpy as np
    import torch

    from repro_torch import _build, convert
    from repro_torch.kernels.hotspot.hotspot import (
        hotspot_hp_step, hotspot_hp_step_plain, hotspot_hpc, hotspot_hpc_plain, shift_rows,
    )
    from repro_torch.kernels.spmm.ops import pad_rhs
    from repro_torch.kernels.spmm.ref import make_problem, to_block_ell
    from repro_torch.kernels.spmm.spmm import BlockEllArrays, spmm_block_ell, spmm_block_ell_plain

    t0 = time.perf_counter()
    per_source = _build.build(verbose=True)
    print(f"build_s={time.perf_counter() - t0:.3f} per_source="
          + json.dumps({k: round(v, 3) for k, v in per_source.items()}))

    kernels = {}
    # -- HOTSPOT: K1 and K2 at the paper's 2048² grid ------------------------
    rng = np.random.default_rng(0)
    rows = cols = cfg.grid
    temp, power = convert.hotspot_grids(
        80.0 + 10.0 * rng.random((rows, cols), np.float32),
        rng.random((rows, cols), np.float32), "cuda")
    steps = cfg.sim_steps
    cells = rows * cols

    got, want = hotspot_hpc(temp, power, cfg, steps), hotspot_hpc_plain(temp, power, cfg, steps)
    err = compare("K1 hotspot_hpc", got, want, HOTSPOT_TOL)
    require(torch.equal(got, want), "K1: not bitwise equal to its plain version")
    ms = time_ms(lambda: hotspot_hpc(temp, power, cfg, steps))
    dev = time_ms(lambda: hotspot_hpc(temp, power, cfg, steps), hold=True)
    plain = time_ms(lambda: hotspot_hpc_plain(temp, power, cfg, steps))
    b, by = bound_ms(3 * cells * 4, STENCIL_FLOPS * cells * steps)
    print(f"K1 2048² x {steps} steps: {ms:.4f} ms ({dev:.4f} ms on the card), "
          f"bound {b:.4f} ms ({by})")

    # the runtime's ACC chunk (phase 3): 128 rows and a halo row each side,
    # steps=1, with the full grid's coefficients
    band_t, band_p = temp[127:257].contiguous(), power[127:257].contiguous()
    got = hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols))
    want = hotspot_hpc_plain(band_t, band_p, cfg, 1, grid=(rows, cols))
    require(torch.equal(got, want), "K1 band: not bitwise equal to its plain version")
    band_ms = time_ms(lambda: hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols)))
    band_dev = time_ms(lambda: hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols)),
                       hold=True)
    band_b, band_by = bound_ms(3 * band_t.numel() * 4, STENCIL_FLOPS * band_t.numel())
    print(f"K1 band {tuple(band_t.shape)} steps=1: bitwise equal, {band_ms:.4f} ms with the "
          f"host's enqueue, {band_dev:.4f} ms on the card, bound {band_b:.4f} ms ({band_by})")
    kernels["hotspot_hpc"] = dict(
        name="hotspot_hpc", route="cuda", source="src/repro_torch/csrc/hotspot.cu",
        replaces="src/repro/kernels/hotspot/hotspot.py:77",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None)

    t_hp, t_plain = temp, temp
    for _ in range(steps):
        t_hp = hotspot_hp_step(t_hp, power, cfg)
        t_plain = hotspot_hp_step_plain(t_plain, shift_rows(t_plain, "up"),
                                        shift_rows(t_plain, "down"), power, cfg)
    err = compare("K2 hotspot_hp_step (8 launches)", t_hp, t_plain, HOTSPOT_TOL)
    ms = time_ms(lambda: hotspot_hp_step(temp, power, cfg))
    dev = time_ms(lambda: hotspot_hp_step(temp, power, cfg), hold=True)
    copies = time_ms(lambda: (shift_rows(temp, "up"), shift_rows(temp, "down")))
    plain = time_ms(lambda: hotspot_hp_step_plain(
        temp, shift_rows(temp, "up"), shift_rows(temp, "down"), power, cfg))
    # one step: T, up, down, P read and T written, plus the two shifted
    # copies (each reads and writes a grid) the HP port materialises
    b, by = bound_ms(9 * cells * 4, STENCIL_FLOPS * cells)
    print(f"K2 one step: {ms:.4f} ms, of which the shifted copies alone take {copies:.4f} ms")
    kernels["hotspot_hp_step"] = dict(
        name="hotspot_hp_step", route="cuda", source="src/repro_torch/csrc/hotspot.cu",
        replaces="src/repro/kernels/hotspot/hotspot.py:110",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None)

    # the unit work of phase 3 alone: a CC band (17 rows, one host thread)
    # and an ACC chunk (128 rows plus halos) through K2 and K1
    from repro_torch.kernels.hotspot.ops import hotspot_step_banded

    host_t, host_p = temp[:19].cpu(), power[:19].cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cc_ms = []
    for _ in range(7):
        t0 = time.perf_counter()
        hotspot_step_banded(host_t, host_p, cfg, (rows, cols))
        cc_ms.append((time.perf_counter() - t0) * 1e3)
    torch.set_num_threads(threads)
    print("band_alone " + json.dumps({
        "cc_17_rows_host_ms": statistics.median(cc_ms),
        "k2_130_rows_ms": time_ms(lambda: hotspot_hp_step(band_t, band_p, cfg, grid=(rows, cols))),
        "k1_130_rows_ms": band_ms,
    }))

    # -- SPMM: K3 on the full paper problem -----------------------------------
    t0 = time.perf_counter()
    problem = make_problem(spmm_cfg.rows, spmm_cfg.cols, spmm_cfg.dense_cols,
                           nnz_mean=spmm_cfg.nnz_per_row_mean,
                           nnz_sigma=spmm_cfg.nnz_per_row_sigma, seed=spmm_cfg.seed)
    t1 = time.perf_counter()
    be = to_block_ell(problem)
    t2 = time.perf_counter()
    ell = BlockEllArrays(be, "cuda")
    rhs_pad = convert.to_tensor(pad_rhs(problem), "cuda")
    torch.cuda.synchronize()
    print(f"spmm set-up: make_problem {t1 - t0:.3f} s, to_block_ell {t2 - t1:.3f} s, "
          f"to card {time.perf_counter() - t2:.3f} s; nnz={int(problem.nnz.sum())} "
          f"maxnnz={problem.vals.shape[1]} row_blocks={be.n_row_blocks} K={be.k_max} "
          f"occupied_blocks={int(be.counts.sum())} vals_GB={be.vals.nbytes / 1e9:.3f}")
    del be

    out = spmm_block_ell(ell, rhs_pad)
    want = spmm_block_ell_plain(ell, rhs_pad)
    err = compare("K3 spmm_block_ell", out, want, SPMM_TOL)
    require(torch.equal(out, want), "K3: not bitwise equal to its plain version")
    ms = time_ms(lambda: spmm_block_ell(ell, rhs_pad), reps=5)
    dev = time_ms(lambda: spmm_block_ell(ell, rhs_pad), reps=5, hold=True)
    plain = time_ms(lambda: spmm_block_ell_plain(ell, rhs_pad), reps=3, warmup=1)

    # yardstick only: the same product as one cuSPARSE call through torch
    nnz_mask = np.arange(problem.vals.shape[1]) < problem.nnz[:, None]
    crow = np.concatenate([[0], np.cumsum(problem.nnz, dtype=np.int64)])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(problem.cols[nnz_mask].astype(np.int64)),
        torch.from_numpy(problem.vals[nnz_mask]), size=(problem.rows, rhs_pad.shape[0]),
        check_invariants=True, device="cuda")
    lib_err = float((torch.sparse.mm(csr, rhs_pad) - want[:problem.rows]).abs().max())
    library = time_ms(lambda: torch.sparse.mm(csr, rhs_pad), reps=5)
    print(f"K3 yardstick torch.sparse.mm (CSR): {library:.4f} ms, max |diff| {lib_err:.3e}")
    del csr

    # what the function needs: every occupied block read once, and a
    # multiply-add per nonzero entry and output column
    occupied = int(ell.counts.sum())
    nnz = int((ell.vals != 0).sum())
    n_dense = rhs_pad.shape[1]
    n_bytes = (occupied * 8 * 128 * 4 + ell.colblocks.numel() * 4 + ell.counts.numel() * 4
               + rhs_pad.numel() * 4 + out.numel() * 4)
    b, by = bound_ms(n_bytes, 2.0 * nnz * n_dense)
    print(f"K3 bound: {n_bytes / 1e9:.4f} GB, {2.0 * nnz * n_dense / 1e9:.4f} GFLOP "
          f"(nnz in blocks {nnz}) -> {b:.4f} ms ({by})")
    kernels["spmm_block_ell"] = dict(
        name="spmm_block_ell", route="cuda", source="src/repro_torch/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm/spmm.py:48",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=library)
    for k in kernels.values():
        print(f"{k['name']}: kernel_ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']}")
    k3_ref = want[:problem.rows, :problem.rhs.shape[1]].clone()
    del ell, out, want
    return kernels, (temp, power), problem, k3_ref


def phase2_spmm_hybrid(problem, k3_ref):
    import numpy as np
    import torch

    from repro_torch.kernels.spmm.ops import make_hybrid_executor
    from repro_torch.kernels.spmm.spmm import spmm_block_ell

    t0 = time.perf_counter()
    ex, order = make_hybrid_executor(problem, device="cuda")
    print(f"hybrid set-up: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    converged = ex.converge(rounds=5)
    t1 = time.perf_counter()
    res, d = ex.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    compare("SPMM hybrid vs K3 plain", res[torch.from_numpy(inv).to(res.device)], k3_ref,
            SPMM_TOL)
    print("spmm_hybrid " + json.dumps({
        "converged_split": [converged.n_dense, converged.n_sparse],
        "run_split": [d.n_dense, d.n_sparse],
        "dense_fraction": d.dense_fraction,
        "dense_rows_per_s": ex.tracker.get("dense"),
        "sparse_rows_per_s": ex.tracker.get("sparse"),
        "converge_5_rounds_s": t1 - t0,
        "run_s": t2 - t1,
        "rows_per_ms": problem.rows / ((t2 - t1) * 1e3),
        "k3_launches": spmm_block_ell.launches,
    }))
    require(spmm_block_ell.launches > 0, "the SPMM hybrid never launched K3")


def phase3_hotspot_runtime(cfg, temp, power):
    import torch

    from repro_torch.kernels.hotspot.ops import hotspot_hetero
    from repro_torch.kernels.hotspot.ref import hotspot_ref

    rows = temp.shape[0]
    want = hotspot_ref(temp, power, cfg, cfg.sim_steps)
    threads = torch.get_num_threads()
    # one intra-op thread each: 4 CC unit threads must not fight over one pool
    torch.set_num_threads(1)
    try:
        for cid, label, port in (("5", "4CC+4HPACC+INT", "hp"), ("7", "4CC+4HPCACC+INT", "hpc")):
            t0 = time.perf_counter()
            run = hotspot_hetero(temp, power, cfg, cfg.sim_steps, port=port, acc_chunk=128)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for rep in run.reports:
                require(rep.items == rows, f"config {cid}: {rep.items} rows of {rows}")
                spans = rep.coverage
                require(spans[0][0] == 0 and spans[-1][1] == rows
                        and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
                        f"config {cid}: coverage is not exact-once")
            compare(f"HOTSPOT config {cid} {label} vs hotspot_ref", run.out, want, HOTSPOT_TOL)
            n = len(run.reports)
            units = sorted(run.reports[0].per_worker_busy)
            print(f"hotspot_table1_{cid} " + json.dumps({
                "label": label,
                "items_per_ms": rows * n / (wall * 1e3),
                "step_items_per_ms_mean": statistics.mean(r.throughput for r in run.reports),
                "wall_s": wall,
                "load_balance_mean": statistics.mean(r.load_balance for r in run.reports),
                "rows": {u: sum(r.per_worker_items.get(u, 0) for r in run.reports) for u in units},
                "busy_s": {u: sum(r.per_worker_busy.get(u, 0.0) for r in run.reports)
                           for u in units},
                "utilization_mean": {u: statistics.mean(r.utilization.get(u, 0.0)
                                                        for r in run.reports) for u in units},
                "dispatch_latency_us": {u: 1e6 * statistics.mean(
                    (r.dispatch_latency or {}).get(u, 0.0) for r in run.reports) for u in units},
                "d2h_s": run.d2h_seconds,
                "cc_writeback_s": run.cc_writeback_seconds,
            }))
    finally:
        torch.set_num_threads(threads)


def phase4_model_kernels():
    """K4 and K5 against their plain versions at the serving path's full widths."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain

    kernels = {}
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).cuda()

    # -- K4 at tinyllama-1.1b's prefill attention ----------------------------
    h, kvh, d = 32, 4, 64
    rows = []
    # 891: the longest served prompt, whose 7128 rows leave a ragged last tile
    for s in (2048, 1000, 891):
        q32, k32, v32 = normal(1, s, h, d), normal(1, s, kvh, d), normal(1, s, kvh, d)
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            label = f"K4 flash_attention S={s} {name}"
            want = flash_attention_plain(q, k, v)
            got = flash_attention(q, k, v).float()
            err = compare(label, got, want.float(), ATTN_TOL[name])
            compare(label + " vs mha_ref", got, mha_ref(q, k, v).float(), ATTN_TOL[name])
            ms = time_ms(lambda: flash_attention(q, k, v))
            dev = time_ms(lambda: flash_attention(q, k, v), hold=True)
            plain = time_ms(lambda: flash_attention_plain(q, k, v), reps=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                          enable_gqa=True)
            lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
            library = time_ms(sdpa)
            el = 2 if dtype == torch.bfloat16 else 4
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
            b, by = bound_ms(fops.kernel_hbm_bytes(1, s, s, h, kvh, d, bytes_per_el=el),
                             fops.kernel_flops(1, s, s, h, d, causal=True), peak)
            rows.append(dict(shape=f"S={s} {name}", max_abs_err=err, ms=ms, device_ms=dev,
                             plain_ms=plain,
                             bound_ms=b, bound_by=by, library_ms=library,
                             x_library=ms / library, library_max_abs_diff=lib_err))
    print("K4 at full width " + json.dumps(rows))
    main_row = rows[0]  # S 2048 bf16: tinyllama's own dtype
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")})

    # -- K5 at mamba2-130m's prefill ------------------------------------------
    h, p, n, chunk = 24, 64, 128, 256
    rows = []
    for s in (2048, 1000, 891):
        x = normal(1, s, h, p)
        log_a = torch.from_numpy(-0.2 * rng.random((1, s, h), np.float32)).cuda()
        bm, cm = normal(1, s, n, scale=0.3), normal(1, s, n, scale=0.3)
        for h0 in (None, normal(1, h, p, n, scale=0.5)):
            label = f"K5 ssd_scan S={s} h0={'nonzero' if h0 is not None else 'none'}"
            y, hf = ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0)
            y_want, h_want = ssd_scan_plain(x, log_a, bm, cm, chunk=chunk, h0=h0)
            err = max(compare(label + " y", y, y_want, SSD_TOL),
                      compare(label + " state", hf, h_want, SSD_TOL))
            ms = time_ms(lambda: ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0))
            dev = time_ms(lambda: ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0), hold=True)
            plain = time_ms(lambda: ssd_scan_plain(x, log_a, bm, cm, chunk=chunk, h0=h0), reps=5)
            b, by = bound_ms(sops.kernel_hbm_bytes(1, s, h, p, n, with_h0=h0 is not None),
                             sops.kernel_flops(1, s, h, p, n))
            rows.append(dict(shape=label[len("K5 ssd_scan "):], max_abs_err=err, ms=ms,
                             device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by))
    print("K5 at full width " + json.dumps(rows))
    main_row = rows[0]  # S 2048, no h0: a prompt's first prefill
    kernels["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:67", library_ms=None,
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by")})
    return kernels


def request_specs(cfg):
    """8 prompts from default_rng(0): 128–1024 tokens, 16–48 new tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(128, 1025, 8)
    return [(rid, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64),
             int(rng.integers(16, 49))) for rid, n in enumerate(lengths)]


def serve(model, params, specs):
    """Serve ``specs`` through a 4-slot continuous inline greedy engine."""
    import torch

    from repro_torch.serving import Request, ServingEngine

    engine = ServingEngine(model, params, slots=4, max_len=2048, mode="continuous",
                           backend="inline", temperature=0.0)
    for rid, prompt, max_new in specs:
        require(bool(engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))),
                f"request {rid} was shed")
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    return engine, results, time.perf_counter() - t0


def profile_top10(fn):
    """The 10 operations with the most device time in one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms_total": total / 1e3,
            "top10": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                      for us, k, c in rows[:10]]}


def phase5_serving(arch: str, wrappers: dict):
    """Serve one model at full width; returns (kernel name, launches)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import make_model

    cfg = get_config(arch)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = request_specs(cfg)
    prompt_lens = [len(p) for _, p, _ in specs]

    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    engine, results, wall = serve(model, params, specs)
    launches = {name: w.launches for name, w in wrappers.items()}

    require(sorted(results) == list(range(len(specs))), f"{arch}: not every request finished")
    for rid, _, max_new in specs:
        r = results[rid]
        require(r.ok and len(r.tokens) == max_new, f"{arch}: request {rid} gave {r.error or len(r.tokens)}")
    rep = engine.last_run_report
    spans = rep.coverage
    require(rep.items == len(specs) and spans[0][0] == 0 and spans[-1][1] == len(specs)
            and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
            f"{arch}: the RunReport does not cover each request exactly once")
    want = cfg.num_layers * len(specs)
    require(launches[kernel] == want,
            f"{arch}: {kernel} launched {launches[kernel]} times, not layers x prefills = {want}")
    others = {k: v for k, v in launches.items() if k != kernel and v}
    require(not others, f"{arch}: unexpected launches {others}")

    tokens = sum(len(r.tokens) for r in results.values())
    ttft = sorted(r.ttft for r in results.values())
    prefill = [results[rid].prefill_seconds * 1e3 for rid, _, _ in specs]
    metrics = {
        "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params_B": sum(t.numel() for t in _leaves(params)) / 1e9,
        "init_s": init_s, "prompt_lens": prompt_lens,
        "max_new": [m for _, _, m in specs],
        f"{kernel}_launches": launches[kernel],
        "ttft_p50_ms": statistics.median(ttft) * 1e3,
        "ttft_max_ms": ttft[-1] * 1e3,
        "prefill_ms_per_request": prefill,
        "prefill_ms_mean": statistics.mean(prefill),
        "prefill_tokens_per_s": sum(prompt_lens) / (sum(prefill) / 1e3),
        "decode_steps": engine.steps,
        "decode_ms_per_step": engine.decode_seconds / max(engine.steps, 1) * 1e3,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"serve {arch} " + json.dumps(metrics))

    longest = specs[int(np.argmax(prompt_lens))][1]
    prompt = torch.as_tensor(longest, device="cuda")[None, :]
    print(f"profile {arch} prefill ({len(longest)} tokens) "
          + json.dumps(profile_top10(lambda: model.prefill(params, prompt, 2048))))
    dec_tokens = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    dec_pos = engine.caches[0].length.long()[:, None] if kernel == "flash_attention" else \
        torch.full((4, 1), max(prompt_lens), device="cuda")
    print(f"profile {arch} decode step (4 slots) " + json.dumps(profile_top10(
        lambda: model.decode_step(params, dec_tokens, dec_pos, engine.caches))))
    bf16_tokens = {rid: r.tokens for rid, r in results.items()}
    del engine, results

    # a float32 copy: the kernels against their plain versions, end to end
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = _to_float32(params)
    del params
    fast, plain = make_model(cfg32, device="cuda"), make_model(cfg32, device="cuda", plain=True)
    _, res_k, _ = serve(fast, params32, specs)
    _, res_p, _ = serve(plain, params32, specs)
    worst = 0.0
    for rid, prompt_np, _ in specs:
        require(res_k[rid].tokens == res_p[rid].tokens,
                f"{arch} f32: request {rid} greedy tokens differ between kernels and plain")
        prompt = torch.as_tensor(prompt_np, device="cuda")[None, :]
        lk, _ = fast.prefill(params32, prompt, 2048)
        lp, _ = plain.prefill(params32, prompt, 2048)
        worst = max(worst, compare(f"{arch} f32 request {rid} last-position logits", lk, lp,
                                   LOGITS_TOL))
    same_as_bf16 = sum(res_k[rid].tokens == bf16_tokens[rid] for rid in bf16_tokens)
    print(f"serve {arch} f32 kernels vs plain: all {len(specs)} token streams equal, logits "
          f"max |diff| {worst:.3e}; {same_as_bf16} of {len(specs)} streams also equal bf16's")
    return kernel, launches[kernel]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float32(v) for v in tree]
    return tree.float()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_eneac import HOTSPOT, SPMM
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.hotspot.hotspot import hotspot_hp_step, hotspot_hpc
    from repro_torch.kernels.spmm.spmm import spmm_block_ell
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "torch.backends.cuda.matmul.allow_tf32 must be False (IEEE f32 parity)")

    kernels, (temp, power), problem, k3_ref = phase1_kernels(HOTSPOT, SPMM)
    print(f"phase 1 done at {time.perf_counter() - t_start:.1f} s")

    wrappers = {"hotspot_hpc": hotspot_hpc, "hotspot_hp_step": hotspot_hp_step,
                "spmm_block_ell": spmm_block_ell}
    for w in wrappers.values():
        w.launches = 0
    phase2_spmm_hybrid(problem, k3_ref)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    phase3_hotspot_runtime(HOTSPOT, temp, power)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for name, w in wrappers.items():
        kernels[name]["launches"] = w.launches
        require(w.launches > 0, f"{name} was not launched on the main path")

    kernels.update(phase4_model_kernels())
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    wrappers.update(flash_attention=flash_attention, ssd_scan=ssd_scan)
    for arch in SERVE_ARCHS:
        name, launches = phase5_serving(arch, wrappers)
        kernels[name]["launches"] = launches
        print(f"phase 5 {arch} done at {time.perf_counter() - t_start:.1f} s")
    print("launches on the main path: "
          + ", ".join(f"{k}={v['launches']}" for k, v in kernels.items()))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: v[k] for k in keys} for v in kernels.values()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

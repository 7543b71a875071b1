"""HOTSPOT execution paths: the Table-1 modes and the runtime-driven run.

The counterpart of ``repro.kernels.hotspot.ops``.  ``hotspot(mode=...)``
selects the Table-1 execution path:

* ``"cc"``  — plain PyTorch (the paper's CPU-core path).
* ``"hp"``  — K2, one launch per time step with materialised halo copies.
* ``"hpc"`` — K1, every time step in one launch.

:func:`hotspot_step_banded` is the scheduler's unit of work for the row
space, and :func:`hotspot_hetero` drives whole time steps through
:class:`~repro_torch.core.runtime.HeteroRuntime`: CC units (host threads)
and ACC units (CUDA streams running K1 or K2) share each step's rows.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import List

import torch
import torch.nn.functional as F

from ...configs.paper_eneac import HotspotConfig
from ...core.backends import CudaStreamUnit
from ...core.interrupts import RunReport
from ...core.runtime import HeteroRuntime
from ...core.scheduler import Chunk, WorkerKind
from .hotspot import hotspot_hp_step, hotspot_hpc
from .ref import hotspot_coefficients, hotspot_ref, hotspot_step_coeffs, hotspot_step_ref

__all__ = ["hotspot", "hotspot_rows_chunk", "hotspot_step_banded", "hotspot_hetero",
           "HeteroHotspotRun", "N_CC", "N_ACC"]

# Table 1's unit counts: 4 CPU cores (CC) beside 4 accelerator units (ACC)
N_CC = 4
N_ACC = 4


def hotspot(
    temp: torch.Tensor,
    power: torch.Tensor,
    cfg: HotspotConfig,
    steps: int,
    *,
    mode: str = "hpc",
) -> torch.Tensor:
    if mode == "cc":
        return hotspot_ref(temp, power, cfg, steps)
    if mode == "hpc":
        return hotspot_hpc(temp, power, cfg, steps)
    if mode == "hp":
        t = temp
        for _ in range(steps):
            t = hotspot_hp_step(t, power, cfg)
        return t
    raise ValueError(f"mode must be cc|hp|hpc, got {mode!r}")


def hotspot_step_banded(
    temp_band: torch.Tensor,   # band rows plus any halo rows already included
    power_band: torch.Tensor,  # same shape as temp_band
    cfg: HotspotConfig,
    grid: tuple,               # (R, C) of the FULL grid
) -> torch.Tensor:
    """One step on a row band, bitwise equal to the whole-grid step.

    The caller slices ``temp``/``power`` to the band *plus one halo row on
    each interior side* and keeps only the band rows of the result.  Using
    the full grid's coefficients (not the band's) is what makes this
    exactly the rows the whole-grid
    :func:`~repro_torch.kernels.hotspot.ref.hotspot_step_ref` would produce.
    """
    cap, rx, ry, rz, dt = hotspot_coefficients(cfg, grid[0], grid[1])
    return hotspot_step_coeffs(temp_band, power_band, cfg.amb_temp,
                               cap, rx, ry, rz, dt)


def hotspot_rows_chunk(
    temp_halo: torch.Tensor,   # (chunk+2, C) — chunk rows plus one halo row each side
    power: torch.Tensor,       # (chunk, C)
    cfg: HotspotConfig,
    steps: int,
) -> torch.Tensor:
    """CC-path work unit for the scheduler: evolve a row chunk.

    Note: for multi-step evolution the halo must be ``steps`` rows deep for
    exactness; with a 1-row halo this is exact for ``steps=1`` only.
    """
    t = temp_halo.clone()
    padded = F.pad(power, (0, 0, 1, 1))
    for _ in range(steps):
        stepped = hotspot_step_ref(t, padded, cfg)
        t[1:-1] = stepped[1:-1]
    return t[1:-1]


@dataclasses.dataclass
class HeteroHotspotRun:
    """What :func:`hotspot_hetero` computed and measured."""

    out: torch.Tensor
    reports: List[RunReport]     # one per time step
    d2h_seconds: float           # the grid copied to the host for the CC units
    cc_writeback_seconds: float  # CC rows copied back into the device grid


def hotspot_hetero(
    temp: torch.Tensor,
    power: torch.Tensor,
    cfg: HotspotConfig,
    steps: int,
    *,
    port: str = "hpc",
    acc_chunk: int = 128,
) -> HeteroHotspotRun:
    """``steps`` time steps, each one ``parallel_for`` over the grid's rows.

    Table 1's hybrid configurations with interrupts (``port="hp"`` is
    4CC+4HPACC+INT, ``port="hpc"`` is 4CC+4HPCACC+INT), with real chunks:
    :data:`N_CC` host-thread units step their rows on a host copy of the
    grid with :func:`hotspot_step_banded` and write them back into the
    device grid; :data:`N_ACC` :class:`CudaStreamUnit` units step their rows
    plus a 1-row halo through K2 (``"hp"``) or K1 with ``steps=1``
    (``"hpc"``) with the full grid's coefficients.  The MultiDynamic policy
    hands ACC units ``acc_chunk`` rows at a time and sizes CC chunks
    adaptively; completions drive dispatch (the ``"interrupt"`` engine).

    ACC units run on ``temp``'s device: a CUDA grid uses the card, and a
    CPU grid (the tests) runs the kernels' plain versions on host threads.
    """
    if port not in ("hp", "hpc"):
        raise ValueError(f"port must be hp|hpc, got {port!r}")
    rows, cols = temp.shape
    grid = (rows, cols)
    acc_step = hotspot_hp_step if port == "hp" else functools.partial(hotspot_hpc, steps=1)
    power_host = power.cpu()
    cur = {}  # this step's grid on the device and on the host, and its output
    lock = threading.Lock()
    writeback = [0.0]

    def halo(chunk: Chunk):
        lo, hi = max(chunk.start - 1, 0), min(chunk.stop + 1, rows)
        return lo, hi, chunk.start - lo

    def cc_work(chunk: Chunk) -> None:
        lo, hi, off = halo(chunk)
        res = hotspot_step_banded(cur["host"][lo:hi], power_host[lo:hi], cfg, grid)
        t0 = time.perf_counter()
        cur["new"][chunk.start:chunk.stop].copy_(res[off:off + chunk.size])
        with lock:
            writeback[0] += time.perf_counter() - t0

    def acc_work(chunk: Chunk) -> torch.Tensor:
        lo, hi, off = halo(chunk)
        res = acc_step(cur["dev"][lo:hi], power[lo:hi], cfg, grid=grid)
        cur["new"][chunk.start:chunk.stop].copy_(res[off:off + chunk.size])
        return res

    rt = HeteroRuntime()
    for i in range(N_ACC):
        rt.register_unit(f"acc{i}", WorkerKind.ACC, work_fn=acc_work,
                         backend=CudaStreamUnit(f"acc{i}", device=temp.device))
    for i in range(N_CC):
        rt.register_unit(f"cc{i}", WorkerKind.CC, work_fn=cc_work, backend="thread")

    reports: List[RunReport] = []
    d2h = 0.0
    t = temp
    for _ in range(steps):
        t0 = time.perf_counter()
        cur["host"] = t.cpu()
        d2h += time.perf_counter() - t0
        cur["dev"] = t
        cur["new"] = torch.empty_like(t)
        reports.append(rt.parallel_for(num_items=rows, policy="multidynamic",
                                       engine="interrupt", acc_chunk=acc_chunk))
        t = cur["new"]
    return HeteroHotspotRun(out=t, reports=reports, d2h_seconds=d2h,
                            cc_writeback_seconds=writeback[0])

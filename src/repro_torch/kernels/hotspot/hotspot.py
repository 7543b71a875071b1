"""HOTSPOT stencil kernels K1 and K2: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.hotspot.hotspot``; the CUDA source is
``repro_torch/csrc/hotspot.cu``.

* :func:`hotspot_hpc` (K1) replaces ``hotspot.py::hotspot_hpc_pallas``, the
  **HPC (cache-coherent) analogue**: all ``steps`` time iterations in one
  launch.  The grid ping-pongs between two device buffers with a grid-wide
  barrier between steps; at 2048² both buffers and the power grid fit in
  the 50 MB L2.  Bound on the card: bytes, one read of T and P and one
  write of T.
* :func:`hotspot_hp_step` (K2) replaces ``hotspot.py::hotspot_hp_step_pallas``,
  the **HP (non-cacheable) analogue**: one launch per time step, with the
  up and down neighbours materialised as shifted copies first (the HP-port
  buffer penalty).  Bound on the card: bytes, 5 × R × C × 4 per launch.

The TPU kernels multiply by the reciprocals of the resistances; these
divide, in the order and rounding of the plain oracle
(:func:`~repro_torch.kernels.hotspot.ref.hotspot_update`), and so give its
bits.  At 2048² the explicit scheme is past its stability limit and a
one-ulp difference grows about 3.4-fold a step (see :mod:`.ref`), so only
the same arithmetic can hold the reference's tolerance after 8 steps.  Each
wrapper takes its plain PyTorch version for a tensor on the CPU, launches
its kernel for a CUDA tensor, and counts its launches in ``.launches``.
``grid=(R, C)`` gives the full grid's shape for the coefficients when the
input is a row band plus halo rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import _build
from ...configs.paper_eneac import HotspotConfig
from .ref import hotspot_coefficients, hotspot_update

__all__ = [
    "hotspot_hpc", "hotspot_hpc_plain", "hotspot_hp_step", "hotspot_hp_step_plain",
    "shift_rows",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_HPC_ARGS = (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P)
_HP_ARGS = (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _P)


def _coeff(cfg: HotspotConfig, shape: Tuple[int, int], grid: Optional[tuple]):
    """(cap, rx, ry, rz, dt) of the full grid, or of ``shape`` without ``grid``."""
    rows, cols = grid if grid is not None else shape
    return hotspot_coefficients(cfg, rows, cols)


def _kernel_coeff(cfg: HotspotConfig, shape: Tuple[int, int], grid: Optional[tuple]):
    """The kernels' float arguments: dt/cap, rx, ry, rz and the ambient temperature."""
    cap, rx, ry, rz, dt = _coeff(cfg, shape, grid)
    return (dt / cap, rx, ry, rz, cfg.amb_temp)


def shift_rows(t: torch.Tensor, direction: str) -> torch.Tensor:
    """The neighbour above (``"up"``: row r-1) or below, edge-clamped."""
    if direction == "up":
        return torch.cat([t[:1], t[:-1]], dim=0)
    return torch.cat([t[1:], t[-1:]], dim=0)


def _shift_cols(t: torch.Tensor, direction: str) -> torch.Tensor:
    if direction == "left":
        return torch.cat([t[:, :1], t[:, :-1]], dim=1)
    return torch.cat([t[:, 1:], t[:, -1:]], dim=1)


def _check_grids(temp: torch.Tensor, power: torch.Tensor) -> None:
    if temp.dim() != 2 or temp.shape != power.shape or temp.numel() == 0:
        raise ValueError(
            f"temp and power must be equal non-empty 2-D grids, got "
            f"{tuple(temp.shape)} and {tuple(power.shape)}"
        )
    if temp.dtype != torch.float32 or power.dtype != torch.float32:
        raise TypeError(f"hotspot kernels take float32, got {temp.dtype}, {power.dtype}")
    if temp.device != power.device:
        raise ValueError(f"temp on {temp.device} but power on {power.device}")
    if temp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hotspot kernels run on cpu or cuda, got {temp.device}")
    if temp.device.type == "cuda" and not (temp.is_contiguous() and power.is_contiguous()):
        raise ValueError("the CUDA hotspot kernels take contiguous grids")


# ---------------------------------------------------------------------------
# K1: HPC variant, every time step in one launch
# ---------------------------------------------------------------------------
def hotspot_hpc_plain(
    temp: torch.Tensor, power: torch.Tensor, cfg: HotspotConfig, steps: int,
    *, grid: Optional[tuple] = None,
) -> torch.Tensor:
    """K1's plain PyTorch version: ``steps`` updates of :func:`hotspot_update`."""
    coeff = _coeff(cfg, temp.shape, grid)
    t = temp.clone()
    for _ in range(steps):
        t = hotspot_update(t, shift_rows(t, "up"), shift_rows(t, "down"),
                           _shift_cols(t, "left"), _shift_cols(t, "right"),
                           power, cfg.amb_temp, *coeff)
    return t


def hotspot_hpc(
    temp: torch.Tensor, power: torch.Tensor, cfg: HotspotConfig, steps: int,
    *, grid: Optional[tuple] = None,
) -> torch.Tensor:
    """``steps`` stencil updates in one launch of K1 (plain version on the CPU)."""
    _check_grids(temp, power)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if steps == 0:
        return temp.clone()
    if temp.device.type == "cpu":
        return hotspot_hpc_plain(temp, power, cfg, steps, grid=grid)
    rows, cols = temp.shape
    coeff = _kernel_coeff(cfg, temp.shape, grid)
    out = torch.empty_like(temp)
    scratch = torch.empty_like(temp) if steps > 1 else out
    launch = _build.function("hotspot", "hotspot_hpc_launch", _HPC_ARGS)
    with torch.cuda.device(temp.device):
        stream = torch.cuda.current_stream(temp.device).cuda_stream
        err = launch(temp.data_ptr(), power.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     rows, cols, steps, *coeff, stream)
    _build.check("hotspot", err, "hotspot_hpc launch")
    _build.count_launch(hotspot_hpc)
    return out


hotspot_hpc.launches = 0


# ---------------------------------------------------------------------------
# K2: HP variant, one step per launch
# ---------------------------------------------------------------------------
def hotspot_hp_step_plain(
    temp: torch.Tensor, up: torch.Tensor, down: torch.Tensor, power: torch.Tensor,
    cfg: HotspotConfig, *, grid: Optional[tuple] = None,
) -> torch.Tensor:
    """K2's plain PyTorch version, on the same materialised shifted copies."""
    return hotspot_update(temp, up, down, _shift_cols(temp, "left"),
                          _shift_cols(temp, "right"), power, cfg.amb_temp,
                          *_coeff(cfg, temp.shape, grid))


def hotspot_hp_step(
    temp: torch.Tensor, power: torch.Tensor, cfg: HotspotConfig,
    *, grid: Optional[tuple] = None,
) -> torch.Tensor:
    """One time step through K2; the halos come in as shifted copies."""
    _check_grids(temp, power)
    up = shift_rows(temp, "up")      # materialised: the HP-port
    down = shift_rows(temp, "down")  # intermediate-buffer penalty
    if temp.device.type == "cpu":
        return hotspot_hp_step_plain(temp, up, down, power, cfg, grid=grid)
    rows, cols = temp.shape
    coeff = _kernel_coeff(cfg, temp.shape, grid)
    out = torch.empty_like(temp)
    launch = _build.function("hotspot", "hotspot_hp_step_launch", _HP_ARGS)
    with torch.cuda.device(temp.device):
        stream = torch.cuda.current_stream(temp.device).cuda_stream
        err = launch(temp.data_ptr(), up.data_ptr(), down.data_ptr(), power.data_ptr(),
                     out.data_ptr(), rows, cols, *coeff, stream)
    _build.check("hotspot", err, "hotspot_hp_step launch")
    _build.count_launch(hotspot_hp_step)
    return out


hotspot_hp_step.launches = 0

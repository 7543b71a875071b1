"""Plain PyTorch oracle for the HOTSPOT stencil (Rodinia thermal simulation).

The counterpart of ``repro.kernels.hotspot.ref``.  One time step of the
explicit solver on a (R, C) grid:

  T'   = T + dt/Cap · ( (T[r,c-1] + T[r,c+1] − 2T)/Rx
                      + (T[r-1,c] + T[r+1,c] − 2T)/Ry
                      + (T_amb − T)/Rz + P )

Boundary cells clamp their missing neighbours to themselves (Rodinia's
edge handling).  The update divides by the resistances, as the reference
oracle does, and every operation rounds to float32 on its own.  The
divisors are 0-dim tensors on the grid's device, because PyTorch turns a
division of a CUDA tensor by a Python float into a multiplication by its
reciprocal; with tensors the division is IEEE on the CPU and the card
alike, so the two give the same bits, and so do the CUDA kernels of
:mod:`.hotspot`, which evaluate the same operations in the same order.

That matters at the paper's 2048² grid: there dt/(Cap·Rx) ≈ 0.55, above
the explicit scheme's stability limit of 0.25, so a one-ulp difference in
one step grows by a factor of up to |1 − 8·0.55| ≈ 3.4 every step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...configs.paper_eneac import HotspotConfig

__all__ = [
    "hotspot_coefficients",
    "hotspot_update",
    "hotspot_step_coeffs",
    "hotspot_step_ref",
    "hotspot_ref",
]


def hotspot_coefficients(cfg: HotspotConfig, rows: int, cols: int) -> Tuple[float, ...]:
    grid_h = cfg.chip_height / rows
    grid_w = cfg.chip_width / cols
    cap = cfg.spec_heat_si * cfg.t_chip * grid_w * grid_h
    rx = grid_w / (2.0 * cfg.k_si * cfg.t_chip * grid_h)
    ry = grid_h / (2.0 * cfg.k_si * cfg.t_chip * grid_w)
    rz = cfg.t_chip / (cfg.k_si * grid_h * grid_w)
    max_slope = cfg.max_pd / (cfg.spec_heat_si * cfg.t_chip)
    dt = cfg.precision / max_slope
    return cap, rx, ry, rz, dt


def hotspot_update(
    t: torch.Tensor, up: torch.Tensor, down: torch.Tensor, left: torch.Tensor,
    right: torch.Tensor, power: torch.Tensor, amb_temp: float,
    cap: float, rx: float, ry: float, rz: float, dt: float,
) -> torch.Tensor:
    """The explicit update of every cell, given its four neighbour grids."""
    def div(x: torch.Tensor, r: float) -> torch.Tensor:
        return x / torch.tensor(r, dtype=x.dtype, device=x.device)

    delta = (dt / cap) * (
        power
        + div(left + right - 2.0 * t, rx)
        + div(up + down - 2.0 * t, ry)
        + div(amb_temp - t, rz)
    )
    return t + delta


def hotspot_step_coeffs(
    temp: torch.Tensor, power: torch.Tensor, amb_temp: float,
    cap: float, rx: float, ry: float, rz: float, dt: float,
) -> torch.Tensor:
    """One explicit step with the coefficients given outright.

    Chunked execution (a row band plus halo rows) runs this identical
    elementwise expression with the full grid's coefficients, which makes
    banded evaluation bitwise equal to the whole-grid step (see
    :func:`repro_torch.kernels.hotspot.ops.hotspot_step_banded`).
    """
    t = temp
    up = torch.cat([t[:1], t[:-1]], dim=0)
    down = torch.cat([t[1:], t[-1:]], dim=0)
    left = torch.cat([t[:, :1], t[:, :-1]], dim=1)
    right = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
    return hotspot_update(t, up, down, left, right, power, amb_temp, cap, rx, ry, rz, dt)


def hotspot_step_ref(temp: torch.Tensor, power: torch.Tensor, cfg: HotspotConfig) -> torch.Tensor:
    rows, cols = temp.shape
    cap, rx, ry, rz, dt = hotspot_coefficients(cfg, rows, cols)
    return hotspot_step_coeffs(temp, power, cfg.amb_temp, cap, rx, ry, rz, dt)


def hotspot_ref(temp: torch.Tensor, power: torch.Tensor, cfg: HotspotConfig, steps: int) -> torch.Tensor:
    out = temp.clone()
    for _ in range(steps):
        out = hotspot_step_ref(out, power, cfg)
    return out

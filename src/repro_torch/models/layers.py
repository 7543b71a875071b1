"""Shared model primitives and the seeded parameter builder.

The port's copy of ``repro.models.layers``: :func:`rms_norm` (the
``1 + weight`` convention), :func:`apply_rope` (split-half) and
:class:`ParamBuilder`, which draws every parameter from one explicit
``torch.Generator`` on the target device with the reference's init scales
(normal with std 1/√fan_in unless a scale is given, zeros, ones,
uniform ranges).  The reference draws from ``jax.random``, so
the two give different values from the same seed; parity tests carry the
reference's parameters across with :mod:`repro_torch.convert` instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["DTYPES", "ParamBuilder", "rms_norm", "apply_rope"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class ParamBuilder:
    """Draws parameters in call order from one seeded generator."""

    def __init__(self, seed: int, dtype: torch.dtype,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def param(self, shape: Sequence[int], *, init: str = "normal",
              scale: Optional[Union[float, Tuple[float, float]]] = None) -> torch.Tensor:
        shape = tuple(shape)
        kw = dict(dtype=torch.float32, device=self.device)
        if init == "normal":
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            x = torch.randn(shape, generator=self.generator, **kw) * std
        elif init == "zeros":
            x = torch.zeros(shape, **kw)
        elif init == "ones":
            x = torch.ones(shape, **kw)
        elif init == "uniform":  # U[lo, hi]
            lo, hi = scale  # type: ignore[misc]
            x = lo + (hi - lo) * torch.rand(shape, generator=self.generator, **kw)
        else:
            raise ValueError(f"unknown init {init!r}")
        return x.to(self.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Split-half convention."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)           # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

"""Shared model primitives and the seeded parameter builder.

The port's copy of ``repro.models.layers``: :func:`rms_norm` (the
``1 + weight`` convention), :func:`layer_norm` (whisper's, with the
population variance), :func:`apply_rope` (split-half),
:func:`sinusoidal_positions` (whisper's encoder positions),
:func:`cross_entropy_loss` (the training loss) and
:class:`ParamBuilder`, which draws every parameter from one explicit
``torch.Generator`` on the target device with the reference's init scales
(normal with std 1/√fan_in unless a scale is given, zeros, ones,
uniform ranges).  The reference draws from ``jax.random``, so
the two give different values from the same seed; parity tests carry the
reference's parameters across with :mod:`repro_torch.convert` instead.

Every builder call names its parameter's logical axes (``"embed"``,
``"qheads"`` …, one per dim, as the reference passes them), which the
other two builders return instead of drawing: :class:`SpecBuilder` the
axes tuple (resolved against a mesh by ``parallel/mesh_rules.py``) and
:class:`AbstractBuilder` a ``meta`` tensor (shape and dtype, no memory).
One code path builds all three trees, so they cannot drift apart.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["DTYPES", "ParamBuilder", "SpecBuilder", "AbstractBuilder", "param_layout", "model_split",
           "rms_norm", "layer_norm", "apply_rope", "sinusoidal_positions", "cross_entropy_loss"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

Axes = Tuple[Optional[str], ...]


def _checked(shape: Sequence[int], axes: Sequence[Optional[str]]) -> Tuple[int, ...]:
    shape = tuple(shape)
    if len(axes) != len(shape):
        raise ValueError(f"a {len(shape)}-d parameter with {len(axes)} logical axes {axes}")
    return shape


class ParamBuilder:
    """Draws parameters in call order from one seeded generator."""

    def __init__(self, seed: int, dtype: torch.dtype,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def param(self, shape: Sequence[int], axes: Sequence[Optional[str]], *,
              init: str = "normal",
              scale: Optional[Union[float, Tuple[float, float]]] = None) -> torch.Tensor:
        shape = _checked(shape, axes)
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


class SpecBuilder:
    """Each parameter's logical axes, in place of the parameter."""

    def param(self, shape: Sequence[int], axes: Sequence[Optional[str]], **_) -> Axes:
        _checked(shape, axes)
        return tuple(axes)


class AbstractBuilder:
    """Each parameter as a ``meta`` tensor: its shape and dtype, no memory."""

    def __init__(self, dtype: torch.dtype) -> None:
        self.dtype = dtype

    def param(self, shape: Sequence[int], axes: Sequence[Optional[str]], **_) -> torch.Tensor:
        return torch.empty(_checked(shape, axes), dtype=self.dtype, device="meta")


def param_layout(build, *args, **kw) -> dict:
    """{name: (logical axes, full shape)} of the flat parameter dict that
    ``build(builder, *args, **kw)`` makes (a model module's ``*_params``)."""
    axes = build(SpecBuilder(), *args, **kw)
    shapes = build(AbstractBuilder(torch.float32), *args, **kw)
    return {k: (axes[k], tuple(shapes[k].shape)) for k in axes}


def model_split(tp, build, *args, **kw) -> Dict[str, Optional[int]]:
    """{name: the dim that ``tp``'s rules split over ``model``, or None} of
    each parameter of the flat dict ``build(builder, *args, **kw)`` makes:
    resolved on a layer's first call and kept in ``tp.layouts`` for every
    later call of the model's forward (remat's recomputation included)."""
    key = (build, args, tuple(sorted(kw.items())))
    dims = tp.layouts.get(key)
    if dims is None:
        dims = tp.layouts[key] = {name: tp.split_dim(axes, shape) for name, (axes, shape)
                                  in param_layout(build, *args, **kw).items()}
    return dims


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # population variance, as jnp.var
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


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


def sinusoidal_positions(seq: int, d: int, *, device="cuda") -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (seq, d), float32."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cross_entropy_loss(
    logits: torch.Tensor,                 # (..., V) any float dtype
    labels: torch.Tensor,                 # (...) int
    mask: Optional[torch.Tensor] = None,
    *,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL in fp32 (+ optional z-loss); returns (loss, denom)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * lse**2
    if mask is not None:
        m = mask.float()
        denom = torch.clamp(m.sum(), min=1.0)
        return (nll * m).sum() / denom, denom
    return nll.mean(), torch.tensor(float(nll.numel()), device=nll.device)

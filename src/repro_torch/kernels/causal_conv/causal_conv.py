"""Depthwise causal conv, its bias and SiLU: one CUDA kernel for Hopper, plain PyTorch beside.

The SSD block (``models/ssm.py``) and RG-LRU's prefill (``models/rglru.py``)
run a depthwise causal conv of width W over (B, S, C) activations; the SSD
block applies SiLU after it.  The JAX package writes it as plain jnp code
and has no Pallas kernel for it, so this kernel replaces none: it replaces
the eager chain the port ran before, :func:`causal_conv_plain` (pad, W
shifted f32 multiply-adds, the bias, casts, SiLU: 14 full-size launches at
W 4 and autograd's chain behind them).  The CUDA source is
``repro_torch/csrc/causal_conv.cu``.

:func:`causal_conv` is a ``torch.autograd.Function``.  For CUDA tensors it
launches the forward kernel, which gives the plain chain's bits, counted in
``causal_conv.launches``; its backward is a kernel of its own that forms the
pre-activation again from the saved x, w and b and sums dw and db without
atomics (two calls give the same bits), counted in
``causal_conv.backward_launches``.  It holds the gradient in f32 where
autograd's chain rounds it to x's type between steps.  Every other tensor
(CPU, and ``meta`` in the dry-run, which charges nothing to the cost report)
runs the plain chain itself, and autograd differentiates it.  The kernels
are built for the width every configuration uses, ``WIDTH`` (4).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ... import _build

__all__ = ["causal_conv", "causal_conv_plain", "causal_conv_backward", "WIDTH", "CTA_ROWS"]

WIDTH = 4         # the kernels' conv width
CTA_ROWS = 512    # rows of S a CTA of the backward kernel sums into one partial

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FWD_ARGS = (_P,) * 4 + (_I,) * 4 + (_L,) * 2 + (_I,) * 2 + (_P,)
_BWD_ARGS = (_P,) * 8 + (_I,) * 4 + (_L,) * 2 + (_I,) * 3 + (_P,)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"need x (B, S, C), w (W, C) and b (C,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    c = x.shape[2]
    if w.shape[1] != c or b.shape[0] != c or w.shape[0] < 1:
        raise ValueError(f"w must be (W, {c}) with W >= 1 and b ({c},), got {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.shape[1] < 1:
        raise ValueError(f"need S >= 1, got x {tuple(x.shape)}")
    if x.stride(2) != 1 and c > 1:
        raise ValueError(f"x's channels must be adjacent (stride 1), got strides {x.stride()}")
    if len({x.device, w.device, b.device}) != 1:
        raise ValueError("the conv's inputs lie on several devices")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"x, w and b must share a dtype, got {x.dtype}, {w.dtype}, {b.dtype}")
    if x.device.type in ("cuda", "meta"):
        if x.dtype not in _DTYPES:
            raise TypeError(f"the CUDA conv kernel takes float32 or bfloat16, got {x.dtype}")
        if w.shape[0] != WIDTH:
            raise ValueError(f"the CUDA conv kernel takes W {WIDTH}, got {w.shape[0]}")
    elif x.device.type != "cpu":
        raise ValueError(f"the conv runs on cpu, cuda or meta, got {x.device}")


def causal_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      silu: bool) -> torch.Tensor:
    """The kernel's plain PyTorch version: x (B, S, C), w (W, C), b (C,) →
    (B, S, C) in x's dtype; with ``silu``, SiLU in float32 after the conv
    and rounded to x's dtype again."""
    W, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):  # W is tiny (4)
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    out = (out + b.float()).to(x.dtype)
    return F.silu(out.float()).to(x.dtype) if silu else out


def _strides(x: torch.Tensor):
    b, s, c = x.shape
    return (x.stride(0) if b > 1 else s * c), (x.stride(1) if s > 1 else c)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, silu: bool) -> torch.Tensor:
    """One forward launch on CUDA tensors, counted once."""
    nb, s, c = x.shape
    out = torch.empty((nb, s, c), dtype=x.dtype, device=x.device)
    w, b = w.contiguous(), b.contiguous()
    launch = _build.function("causal_conv", "causal_conv_forward", _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), nb, s, c,
                     w.shape[0], *_strides(x), _DTYPES[x.dtype], int(silu), stream)
    _build.check("causal_conv", err, "causal_conv launch")
    _build.count_launch(causal_conv)
    return out


def causal_conv_backward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor, *,
                         silu: bool):
    """One call of the backward kernels on CUDA tensors (the gradients, then
    the sum of the CTAs' partials of dw and db), counted once in
    ``causal_conv.backward_launches``: (dx, dw, db) for the gradient ``g``
    of the output."""
    _check(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"the conv's backward kernels run on cuda, got {x.device}")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"the output's gradient must be {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    nb, s, c = x.shape
    width = w.shape[0]
    g = g.to(x.dtype).contiguous()
    w, b = w.contiguous(), b.contiguous()
    dx = torch.empty((nb, s, c), dtype=x.dtype, device=x.device)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    partial = torch.empty((nb * -(-s // CTA_ROWS), width + 1, c), dtype=torch.float32,
                          device=x.device)
    launch = _build.function("causal_conv", "causal_conv_backward", _BWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
                     dw.data_ptr(), db.data_ptr(), partial.data_ptr(), nb, s, c, width,
                     *_strides(x), _DTYPES[x.dtype], int(silu), CTA_ROWS, stream)
    _build.check("causal_conv", err, "causal_conv backward launch")
    _build.count_launch(causal_conv, "backward_launches")
    return dx, dw, db


class _CausalConv(torch.autograd.Function):
    """The conv with a gradient on the card: the forward kernel, and the
    backward kernels from the saved x, w and b."""

    @staticmethod
    def forward(ctx, x, w, b, silu: bool):
        ctx.save_for_backward(x, w, b)
        ctx.silu = silu
        return _launch(x, w, b, silu)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        grads = causal_conv_backward(*ctx.saved_tensors, g, silu=ctx.silu)
        return tuple(d if n else None for d, n in zip(grads, need)) + (None,)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, silu: bool) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, C) with w (W, C) and bias b (C,),
    then SiLU where ``silu``: (B, S, C) in x's dtype, contiguous,
    differentiable in x, w and b.  x may be a column slice of wider rows."""
    _check(x, w, b)
    if x.device.type != "cuda":
        return causal_conv_plain(x, w, b, silu=silu)
    return _CausalConv.apply(x, w, b, silu)


causal_conv.launches = 0
causal_conv.backward_launches = 0

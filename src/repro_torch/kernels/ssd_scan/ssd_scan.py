"""SSD chunked scan, K5: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.ssd_scan.ssd_scan``; the CUDA source is
``repro_torch/csrc/ssd_scan.cu``.  :func:`ssd_scan` (K5) replaces
``ssd_scan_pallas``: per chunk of ``Q`` steps, with ``cs = cumsum(log_a)``,

    y  = (C·Bᵀ ⊙ tril(exp(cs_i − cs_j)))·x + exp(cs)·(C·hᵀ)
    h' = exp(cs_Q)·h + (x ⊙ exp(cs_Q − cs))ᵀ·B

carrying the (P, N) state ``h`` from chunk to chunk.  It adds what the
model needs and the TPU kernel lacks: a carried-in state ``h0`` and any
sequence length (the last chunk may be partial, as if padded with
``log_a = 0`` and ``B = 0``).

The output does not depend on the chunk length, so the CUDA kernels work
at their own sub-chunk of :data:`SUB` steps whatever ``chunk`` the caller
names: per sub-chunk its state contribution (in parallel), then the state
recurrence over the sub-chunks in order, then y from the states passed in
(in parallel).  The plain version is
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked`, at the caller's
chunk.  The wrapper takes it for tensors on the CPU, launches the kernels
for CUDA tensors, and counts each call in ``ssd_scan.launches`` (one call
runs three kernels on the stream).  On ``meta`` tensors (the dry-run) it
checks what the CUDA route checks, returns meta outputs and charges
``ops.kernel_flops`` / ``kernel_hbm_bytes`` to the active cost report
(``repro_torch/costs.py``): priced, not launched, not counted.

**Gradients.**  :func:`ssd_scan` is a ``torch.autograd.Function``: ``y``
and the final state require grad whenever an input does, on either
device.  The forward is the kernels (the plain version for CPU tensors),
and it saves ``x``, ``log_a``, ``B``, ``C`` and ``h0``.  The backward is
the gradient of the same function, taken by autograd through the plain
version recomputed from the saved inputs at the caller's chunk; it takes
a gradient for ``y``, for the final state, or for both.  This is no
fallback: the values the model uses always come from the kernels on the
card, and a failed launch still raises.  The JAX package has no backward
kernel either (its model never calls K5, and its training takes XLA's
autodiff of plain ``jnp`` code), so autodiff of the plain version is the
port's equivalent.  A backward kernel written by hand is later speed work
(ROADMAP.md queue 2), not a kernel still to port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import _build, costs
from .ref import ssd_chunked

__all__ = ["ssd_scan", "ssd_scan_plain", "SUB", "MAX_STATE", "BACKWARD_LABEL"]

# the profiler's name for the backward's recomputation
BACKWARD_LABEL = "ssd_scan backward (plain recomputation)"

SUB = 64          # the CUDA kernels' sub-chunk (steps)
MAX_STATE = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P,) * 10 + (_I,) * 7 + (_P,)


def _check(x, log_a, Bm, Cm, chunk: int, h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if log_a.shape != (b, s, h):
        raise ValueError(f"log_a must be {(b, s, h)}, got {tuple(log_a.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C must be (B, S, N) with B, S = {b}, {s}; got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    n = Bm.shape[2]
    if h0 is not None and h0.shape != (b, h, p, n):
        raise ValueError(f"h0 must be {(b, h, p, n)}, got {tuple(h0.shape)}")
    if s < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got S={s}, chunk={chunk}")
    tensors = [x, log_a, Bm, Cm] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K5's inputs lie on several devices")
    if x.device.type in ("cuda", "meta"):
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError("the CUDA K5 kernel takes float32 inputs")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA K5 kernel takes contiguous tensors")
        if n > MAX_STATE:
            raise ValueError(f"the CUDA K5 kernel takes N <= {MAX_STATE}, got {n}")
    elif x.device.type != "cpu":
        raise ValueError(f"K5 runs on cpu, cuda or meta, got {x.device}")


def ssd_scan_plain(x, log_a, Bm, Cm, *, chunk: int = 64,
                   h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain PyTorch version: the chunked algorithm in tensor ops."""
    return ssd_chunked(x, log_a, Bm, Cm, chunk, h0)


def _launch(x, log_a, Bm, Cm, h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the CUDA kernels on CUDA tensors (three launches), counted once."""
    b, s, h, p = x.shape
    n = Bm.shape[2]
    n_sub = (s + SUB - 1) // SUB
    y = torch.empty_like(x)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # scratch: each sub-chunk's state contribution, overwritten by the state
    # entering it; its decay exp(cs_Q); its C·Bᵀ, shared by the heads
    states = torch.empty((b, n_sub, h, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, n_sub, h), dtype=torch.float32, device=x.device)
    gram = torch.empty((b, n_sub, SUB, SUB), dtype=torch.float32, device=x.device)
    launch = _build.function("ssd_scan", "ssd_scan_launch", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                     h_out.data_ptr(), states.data_ptr(), decay.data_ptr(), gram.data_ptr(),
                     b, s, h, p, n, SUB, x.device.index, stream)
    _build.check("ssd_scan", err, "ssd_scan launch")
    _build.count_launch(ssd_scan)
    return y, h_out


def _priced(x, Bm, h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The meta route: K5's forward cost charged to the active cost report
    (``repro_torch/costs.py``), meta outputs, no launch."""
    from .ops import kernel_flops, kernel_hbm_bytes

    b, s, h, p = x.shape
    n = Bm.shape[2]
    costs.charge("ssd_scan", kernel_flops(b, s, h, p, n),
                 kernel_hbm_bytes(b, s, h, p, n, with_h0=h0 is not None))
    return torch.empty_like(x), torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)


class _SsdScan(torch.autograd.Function):
    """K5 with a gradient: the forward is the kernels (the plain version on
    the CPU, the priced meta route on ``meta``), the backward autograd of
    the plain version recomputed from the saved x, log_a, B, C and h0."""

    @staticmethod
    def forward(ctx, x, log_a, Bm, Cm, h0, chunk: int):
        ctx.save_for_backward(x, log_a, Bm, Cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an output that reaches no loss: None
        if x.device.type == "cpu":
            return ssd_scan_plain(x, log_a, Bm, Cm, chunk=chunk, h0=h0)
        if x.device.type == "meta":
            return _priced(x, Bm, h0)
        return _launch(x, log_a, Bm, Cm, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        need = ctx.needs_input_grad[:5]
        if grad_y is None and grad_h is None:
            return (None,) * 6
        with torch.profiler.record_function(BACKWARD_LABEL), torch.enable_grad():
            leaves = [x if x is None else x.detach().requires_grad_(n)
                      for x, n in zip(ctx.saved_tensors, need)]
            outs = ssd_scan_plain(*leaves[:4], chunk=ctx.chunk, h0=leaves[4])
            # y, the final state, or both reach the loss
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_h)) if g is not None]
            # C reaches y only: through the final state alone its gradient is None (zero)
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [x for x in leaves if x is not None and x.requires_grad],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if n else None for n in need) + (None,)


def ssd_scan(x, log_a, Bm, Cm, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P), final state (B, H, P, N)) through K5, in float32,
    differentiable in every input."""
    _check(x, log_a, Bm, Cm, chunk, h0)
    return _SsdScan.apply(x, log_a, Bm, Cm, h0, chunk)


ssd_scan.launches = 0

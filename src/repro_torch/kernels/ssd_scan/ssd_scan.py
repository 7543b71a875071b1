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
device, and the Function saves ``x``, ``log_a``, ``B``, ``C`` and ``h0``.
It takes a gradient for ``y``, for the final state, or for both.  On the
card the backward is a kernel of its own (``csrc/ssd_scan.cu``, at the
same sub-chunk of :data:`SUB` steps): it recomputes the state entering
each sub-chunk with the forward's first two kernels (no scratch is held
between the forward and the backward), runs the state's gradient from the
last sub-chunk to the first, then forms dx and dlog_a's shares per
sub-chunk and head, and dB and dC per sub-chunk and 64 columns of N,
walking the heads in order, with no atomics (two calls give the same
bits); it is counted in
``ssd_scan.backward_launches``, apart from the forward's ``launches``.
:func:`ssd_scan_backward_plain` computes the same gradient in tensor ops
from the same formulas, for the tests and ``chip_smoke.py``.  The JAX
package has no backward kernel (its model never calls K5, and its
training takes XLA's autodiff of plain ``jnp`` code), so on the CPU the
backward is autograd of the plain version recomputed from the saved
inputs at the caller's chunk, and on ``meta`` it charges the backward
kernels' own operations and bytes to the cost report
(``ssd_scan_backward``) and returns meta gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ... import _build, costs
from .ref import ssd_chunked

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_backward", "ssd_scan_backward_plain", "SUB",
           "MAX_STATE"]

SUB = 64          # the CUDA kernels' sub-chunk (steps)
MAX_STATE = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P,) * 10 + (_I,) * 7 + (_P,)
_BWD_ARGS = (_P,) * 19 + (_I,) * 8 + (_P,)


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


def ssd_scan_backward_plain(x, log_a, Bm, Cm, h0: Optional[torch.Tensor],
                            grad_y: Optional[torch.Tensor], grad_h: Optional[torch.Tensor]):
    """The backward kernels' plain PyTorch version: (dx, dlog_a, dB, dC,
    dh0 or None) for the gradient ``grad_y`` of y and ``grad_h`` of the final
    state (either may be None: 0), from the formulas the kernels evaluate,
    per sub-chunk of :data:`SUB` steps (the last padded with log_a 0, B, C,
    x and dy 0), with cs the sub-chunk's cumsum of log_a, G = C·Bᵀ, L_ij =
    exp(cs_i − cs_j) on and below the diagonal, w = exp(cs_Q − cs), h_in and
    dh_out the state entering and the gradient of the state leaving the
    sub-chunk.  Used by the tests and ``chip_smoke.py``, never on the main
    path."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = SUB
    pad = -s % q
    f = torch.nn.functional.pad

    def padded(t):
        return f(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    dy = torch.zeros_like(x) if grad_y is None else grad_y
    xr, dyr = (padded(t).reshape(b, -1, q, h, p) for t in (x, dy))
    nc = xr.shape[1]
    ar = f(log_a.float(), (0, 0, 0, pad)).reshape(b, nc, q, h)
    Br, Cr = (padded(t).reshape(b, nc, q, n) for t in (Bm, Cm))
    cs = torch.cumsum(ar, dim=2)                                            # (b,c,q,h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    L = torch.exp((cs[:, :, :, None] - cs[:, :, None]).masked_fill(~tri, float("-inf")))
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    ecs, w = torch.exp(cs), torch.exp(cs[:, :, -1:] - cs)
    decay = ecs[:, :, -1]                                                   # (b,c,h)
    # the state entering each sub-chunk, and the gradient of the state leaving it
    contrib = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Br, w, xr)
    back = torch.einsum("bcin,bcih,bcihp->bchpn", Cr, ecs, dyr)
    run = torch.zeros((b, h, p, n), device=x.device) if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(run)
        run = decay[:, c, :, None, None] * run + contrib[:, c]
    run = torch.zeros((b, h, p, n), device=x.device) if grad_h is None else grad_h.float()
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = run
        run = decay[:, c, :, None, None] * run + back[:, c]
    h_in, dh_out = torch.stack(h_in, dim=1), torch.stack(dh_out, dim=1)   # (b,c,h,p,n)
    M = L * torch.einsum("bcihp,bcjhp->bcijh", dyr, xr)                    # L ⊙ (dy_i · x_j)
    t = G[..., None] * M
    U = torch.einsum("bcjn,bchpn->bcjhp", Br, dh_out)
    V = torch.einsum("bcin,bchpn->bcihp", Cr, h_in)
    dx = torch.einsum("bcijh,bcihp->bcjhp", G[..., None] * L, dyr) + w[..., None] * U
    dC = (torch.einsum("bcijh,bcjn->bcin", M, Br)
          + torch.einsum("bcih,bcihp,bchpn->bcin", ecs, dyr, h_in))
    dB = (torch.einsum("bcijh,bcin->bcjn", M, Cr)
          + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xr, dh_out))
    e2 = w * (xr * U).sum(-1)
    dcs = t.sum(3) - t.sum(2) + ecs * (dyr * V).sum(-1) - e2
    dcs[:, :, -1] += e2.sum(2) + decay * (dh_out * h_in).sum((-2, -1))
    dla = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    return (dx.reshape(b, nc * q, h, p)[:, :s], dla.reshape(b, nc * q, h)[:, :s],
            dB.reshape(b, nc * q, n)[:, :s], dC.reshape(b, nc * q, n)[:, :s],
            None if h0 is None else run)


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


def head_groups(b: int, s: int, h: int, n: int, sms: int) -> int:
    """The groups of heads the dB and dC kernel splits its walk into: one
    where its CTAs (a sub-chunk, a batch row, 64 columns of N each) fill a
    wave of the card's ``sms`` SMs (one CTA an SM), else as many as still
    fit in one wave, at most H."""
    ctas = -(-s // SUB) * b * -(-n // SUB)
    return max(1, min(h, sms // ctas))


def backward_scratch(b: int, s: int, h: int, p: int, n: int, device, groups: int = 1) -> dict:
    """The backward kernels' scratch, in the order the C entry point takes
    it: the state entering each sub-chunk and the gradient of the state
    leaving it, exp(cs_Q), C·Bᵀ, the final state (unused), the heads' and P
    tiles' shares of dcs, and with several head ``groups`` their sums of dB
    and dC (None with one).  Within a group dB and dC are summed over the
    heads in registers: no scratch holds a head's share of them."""
    n_sub, p_tiles = -(-s // SUB), -(-p // SUB)
    new = functools.partial(torch.empty, dtype=torch.float32, device=device)
    return {"states": new((b, n_sub, h, p, n)), "dstates": new((b, n_sub, h, p, n)),
            "decay": new((b, n_sub, h)), "gram": new((b, n_sub, SUB, SUB)),
            "h_last": new((b, h, p, n)), "part_cs": new((b, n_sub, h, p_tiles, SUB)),
            "part_groups": new((groups, 2, b, s, n)) if groups > 1 else None}


def ssd_scan_backward(x, log_a, Bm, Cm, h0: Optional[torch.Tensor],
                      grad_y: Optional[torch.Tensor], grad_h: Optional[torch.Tensor]):
    """One call of the backward kernels on CUDA tensors (six launches on the
    stream, seven where dB and dC walk the heads in groups), counted once in
    ``ssd_scan.backward_launches``: (dx, dlog_a, dB, dC, dh0 or None) for
    the gradients of y and of the final state (either may be None: 0)."""
    _check(x, log_a, Bm, Cm, 1, h0)
    if x.device.type != "cuda":
        raise ValueError(f"the K5 backward kernels run on cuda, got {x.device}")
    b, s, h, p = x.shape
    n = Bm.shape[2]
    for name, g, shape in (("y", grad_y, x.shape), ("the final state", grad_h, (b, h, p, n))):
        if g is not None and (g.shape != shape or g.device != x.device):
            raise ValueError(f"the gradient of {name} must be {tuple(shape)} on {x.device}, got "
                             f"{tuple(g.shape)} on {g.device}")
    dy = torch.zeros_like(x) if grad_y is None else grad_y.float().contiguous()
    dh = None if grad_h is None else grad_h.float().contiguous()
    dx, dla, dbm, dcm = (torch.empty_like(t) for t in (x, log_a, Bm, Cm))
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    groups = head_groups(b, s, h, n, torch.cuda.get_device_properties(x.device)
                         .multi_processor_count)
    scratch = backward_scratch(b, s, h, p, n, x.device, groups)
    launch = _build.function("ssd_scan", "ssd_scan_backward_launch", _BWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*(ptr(t) for t in (x, log_a, Bm, Cm, h0, dy, dh, dx, dla, dbm, dcm, dh0)),
                     *(ptr(t) for t in scratch.values()), b, s, h, p, n, SUB, groups,
                     x.device.index, stream)
    _build.check("ssd_scan", err, "ssd_scan backward launch")
    _build.count_launch(ssd_scan, "backward_launches")
    return dx, dla, dbm, dcm, dh0


def _priced_backward(x, log_a, Bm, Cm, h0):
    """The meta route of the backward: the backward kernels' own cost
    charged to the active cost report, meta gradients, no launch."""
    from .ops import backward_flops, backward_hbm_bytes

    b, s, h, p = x.shape
    n = Bm.shape[2]
    costs.charge("ssd_scan_backward", backward_flops(b, s, h, p, n),
                 backward_hbm_bytes(b, s, h, p, n, with_h0=h0 is not None))
    return tuple(None if t is None else torch.empty_like(t) for t in (x, log_a, Bm, Cm, h0))


class _SsdScan(torch.autograd.Function):
    """K5 with a gradient.  On the card: the forward kernels and the
    backward kernels.  On the CPU: the plain version, and autograd of it
    recomputed from the saved x, log_a, B, C and h0.  On ``meta``: both
    priced."""

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
        saved = ctx.saved_tensors
        if saved[0].device.type == "cuda":
            grads = list(ssd_scan_backward(*saved, grad_y, grad_h))
        elif saved[0].device.type == "meta":
            grads = list(_priced_backward(*saved))
        else:
            with torch.enable_grad():
                leaves = [x if x is None else x.detach().requires_grad_(n)
                          for x, n in zip(saved, need)]
                outs = ssd_scan_plain(*leaves[:4], chunk=ctx.chunk, h0=leaves[4])
                # y, the final state, or both reach the loss
                pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_h)) if g is not None]
                grads = iter(torch.autograd.grad(
                    [o for o, _ in pairs],
                    [x for x in leaves if x is not None and x.requires_grad],
                    [g for _, g in pairs], allow_unused=True))
            grads = [next(grads) if n else None for n in need]
        # C reaches y only: through the final state alone its gradient is None (zero)
        if grad_y is None:
            grads[3] = None
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def ssd_scan(x, log_a, Bm, Cm, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P), final state (B, H, P, N)) through K5, in float32,
    differentiable in every input."""
    _check(x, log_a, Bm, Cm, chunk, h0)
    return _SsdScan.apply(x, log_a, Bm, Cm, h0, chunk)


ssd_scan.launches = 0
ssd_scan.backward_launches = 0

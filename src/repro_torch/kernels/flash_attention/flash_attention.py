"""Flash attention forward, K4: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.flash_attention.flash_attention``; the
CUDA source is ``repro_torch/csrc/flash_attention.cu``.
:func:`flash_attention` (K4) replaces ``flash_attention_pallas``: GQA
attention with an online softmax in float32, causal (top-left aligned:
query ``i`` sees keys ``j <= i``) and/or windowed (``j > i - window``)
masks, the output ``acc / max(l, 1e-30)`` in ``q``'s dtype.  Any ``Sq``
and ``Sk`` reach the kernel: it masks the ragged last tiles itself.

The dtype selects the kernel.  bfloat16 runs on the tensor cores, bound
by operations (``ops.kernel_flops`` over the 989 TFLOP/s bf16 peak):
``wgmma`` forms S = Q·Kᵀ and O += P·V in f32 accumulators, the K/V tiles
arrive by asynchronous copies into a two-stage ring on mbarriers, and the
softmax stays in f32 registers; only P is rounded to bf16 before P·V,
which stays within the bf16 tolerance (2e-2).  float32 runs on the CUDA
cores in f32 FMA, held to 2e-4 / 2e-5: the tensor cores would need TF32
operands there, and that path already beats PyTorch's f32 attention.

:func:`flash_attention_plain` computes the same function densely with the
kernel's arithmetic: ``q`` scaled before the product, masked scores set
to ``-0.7 · FLT_MAX`` (not ``-inf``, so a fully masked row averages V as
the kernel does instead of giving NaN).

The kernel takes every head dim D from 1 to :data:`MAX_HEAD_DIM` (256),
as padded widths whose extra columns are zero in shared memory; a larger
D raises (no config of the repo has one; ROADMAP.md queue 3 lists it as a
deliberate difference from the reference, which takes any D).

The wrapper takes the plain version for tensors on the CPU, launches the
kernel for CUDA tensors (made contiguous first where they are not), and
counts its launches in ``flash_attention.launches``.  On ``meta`` tensors
(the dry-run) it checks what the CUDA route checks, returns a meta output
and charges ``ops.kernel_flops`` / ``kernel_hbm_bytes`` to the active
cost report (``repro_torch/costs.py``): priced, not launched, not
counted.  The bf16 kernel loads whole 8-column chunks of 16-byte aligned
rows, so for it the wrapper
pads D to a multiple of 8 with zero columns (and slices the output back),
and copies an unaligned tensor to a fresh buffer.

**Gradients.**  :func:`flash_attention` is a ``torch.autograd.Function``:
its output requires grad whenever ``q``, ``k`` or ``v`` does, on either
device.  The forward is the kernel above (the plain version for CPU
tensors), and it saves ``q``, ``k`` and ``v``.  The backward is the
gradient of the same function, taken by autograd through the plain
version recomputed from the saved inputs (with the causal flag, window
and scale).  This is no fallback: the value the model uses always comes
from the kernel on the card, and a failed launch still raises.  The JAX
package has no backward kernel either (its model never calls K4, and its
training takes XLA's autodiff of plain ``jnp`` code), so autodiff of the
plain version is the port's equivalent.  The recomputation holds float32
scores of shape (B, KVH, G, Sq, Sk): 2.1 GB at a microbatch of 4 × 2048
with 32 heads, several such tensors at once, one layer at a time under
remat.  A backward kernel written by hand is later speed work (ROADMAP.md
queue 2), not a kernel still to port.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build, costs

__all__ = ["MASK_VALUE", "MAX_HEAD_DIM", "BACKWARD_LABEL", "flash_attention",
           "flash_attention_plain"]

# the profiler's name for the backward's recomputation
BACKWARD_LABEL = "flash_attention backward (plain recomputation)"
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KVH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"K4 takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("K4's inputs lie on several devices")
    if d < 1:
        raise ValueError(f"K4 needs a head dim of at least 1, got {d}")
    if q.device.type in ("cuda", "meta"):
        if d > MAX_HEAD_DIM:
            raise ValueError(f"the CUDA K4 kernel takes head_dim up to {MAX_HEAD_DIM}, got {d} "
                             "(ROADMAP.md queue 3: a deliberate difference from the reference)")
    elif q.device.type != "cpu":
        raise ValueError(f"K4 runs on cpu, cuda or meta, got {q.device}")


def _bf16_operand(x: torch.Tensor, d8: int) -> torch.Tensor:
    """``x`` (contiguous) as the bf16 kernel's 16-byte copies take it: D
    padded with zero columns to ``d8``, on a 16-byte aligned buffer."""
    if x.shape[-1] != d8:
        return torch.nn.functional.pad(x, (0, d8 - x.shape[-1]))
    return x.clone() if x.data_ptr() % 16 else x


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """K4's plain PyTorch version: one softmax over all keys at once."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, kvh, g, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())        # (B,KVH,G,Sq,Sk)
    if causal or window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= kp > qp - window
        s = s.masked_fill(~keep, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
            scale: float) -> torch.Tensor:
    """One launch of the CUDA kernel on CUDA tensors, counted."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dk = d
    if q.dtype == torch.bfloat16:
        dk = -(-d // 8) * 8
        q, k, v = (_bf16_operand(x, dk) for x in (q, k, v))
    out = torch.empty_like(q)
    launch = _build.function("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, sk, h, kvh, dk, _DTYPE_CODE[q.dtype], int(causal), int(window),
                     float(scale), stream)
    _build.check("flash_attention", err, "flash_attention launch")
    _build.count_launch(flash_attention)
    return out if dk == d else out[..., :d].contiguous()


def _priced(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """The meta route: K4's forward cost charged to the active cost report
    (``repro_torch/costs.py``), a meta output, no launch."""
    from .ops import kernel_flops, kernel_hbm_bytes, window_share

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    flops = kernel_flops(b, sq, sk, h, d, causal=causal) * window_share(sq, sk, causal, window)
    costs.charge("flash_attention", flops,
                 kernel_hbm_bytes(b, sq, sk, h, kvh, d, bytes_per_el=q.element_size()))
    return torch.empty_like(q)


class _FlashAttention(torch.autograd.Function):
    """K4 with a gradient: the forward is the kernel (the plain version on
    the CPU, the priced meta route on ``meta``), the backward autograd of
    the plain version recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, **ctx.mask)
        if q.device.type == "meta":
            return _priced(q, k, causal, window)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.profiler.record_function(BACKWARD_LABEL), torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
            out = flash_attention_plain(*leaves, **ctx.mask)
            grads = iter(torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                             grad_out))
        return tuple(next(grads) if n else None for n in need) + (None, None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention forward through K4; returns (B, Sq, H, D) in q's dtype,
    differentiable in q, k and v."""
    _check(q, k, v)
    scale = q.shape[-1]**-0.5 if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0

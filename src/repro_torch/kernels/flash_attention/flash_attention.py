"""Flash attention forward, K4: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.flash_attention.flash_attention``; the
CUDA sources are ``repro_torch/csrc/flash_attention.cu`` (bf16 up to D 128),
``repro_torch/csrc/flash_attention_wide.cu`` (bf16 past it) and
``repro_torch/csrc/flash_attention_f32.cu`` (float32).
:func:`flash_attention` (K4) replaces ``flash_attention_pallas``: GQA
attention with an online softmax in float32, causal (top-left aligned:
query ``i`` sees keys ``j <= i``) and/or windowed (``j > i - window``)
masks, the output ``acc / max(l, 1e-30)`` in ``q``'s dtype.  Any ``Sq``
and ``Sk`` reach the kernel: it masks the ragged last tiles itself.

The dtype selects the kernel.  bfloat16 runs on the tensor cores, bound
by operations (``ops.kernel_flops`` over the 989 TFLOP/s bf16 peak):
``wgmma`` forms S = Q·Kᵀ and O += P·V in f32 accumulators, the K/V tiles
arrive by asynchronous copies into rings on mbarriers, and the softmax
stays in f32 registers; only P is rounded to bf16 before P·V, which stays
within the bf16 tolerance (2e-2).  Up to D 128 one warpgroup takes 64 rows
a CTA; past it ``flash_fwd_bf16_wide`` runs two warpgroups of 64 rows on
one ring of key tiles (filled by a producer warpgroup up to D 160, by the
two warpgroups past it), each overlapping its softmax with its products,
and counts its launches in ``flash_attention.wide_launches`` too.  Every
walk over the key tiles starts at the CTA's first row's window edge
(:func:`forward_walk`).  float32, held to 2e-4 / 2e-5 of the plain
version, runs on the tensor cores too: each f32 operand is split into three
bf16 pieces (:func:`three_pieces`) and each product is the six products of
pieces whose indices sum to at most 2, near-f32 arithmetic (TF32's 10-bit
mantissas alone would miss the tolerance); one warpgroup takes 64 rows a
CTA at every width, and the launches count in
``flash_attention.f32_launches`` too.

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
counted.  The kernels load whole 16-byte chunks of 16-byte aligned rows,
so the wrapper pads D to a multiple of 8 (bf16) or 4 (f32) with zero
columns (and slices the output back), and copies an unaligned tensor to a
fresh buffer.

**Gradients.**  :func:`flash_attention` is a ``torch.autograd.Function``:
its output requires grad whenever ``q``, ``k`` or ``v`` does, on either
device.  On the card the forward kernel then also writes each row's final
max ``m`` and denominator ``l`` (two f32 arrays of (B, H, Sq), not one
logsumexp: a fully masked row has ``m = MASK_VALUE``, where ``m + log l``
rounds back to ``m``), and the Function saves q, k, v and those
statistics.  The backward is a kernel of its own
(``csrc/flash_attention_bwd.cu``), recomputing S from q and k in the
forward's arithmetic, with no atomics (two calls give the same bits).  In
bf16 it is two launches on ``wgmma``: per 64 rows the row sum L of
exp(S − m), Δ = rowsum(P ∘ dP) with P = exp(S − m) / L, and dQ; then dK
and dV per 64 keys, with P and dS kept in registers as the A operand of
their products; tiles arrive by asynchronous copies into a ring of stages,
and the CTAs with the longest causal walks start first.  Past D 128 (padded
widths 192 and 256) each kernel runs two warpgroups a CTA: the rows kernel
gives each 64 rows of its own (DP 192) or half of each key tile's keys
(DP 256), the dK/dV kernel half of dK's and dV's columns; and where the dK/dV grid (batch × kv heads × 64-key tiles) is
short of a wave of the card's SMs, each key tile's row walk is cut into
:func:`walk_splits` ranges whose f32 sums a third launch adds in order (f32
scratch the wrapper allocates).  In bf16 up to D 128 P and dS enter the
products as two bf16 operands each (the value and its rounding's
remainder), past it as one.  float32 (``csrc/flash_attention_f32_bwd.cu``)
runs the same two launches on ``wgmma`` with every operand as three bf16
pieces, one warpgroup a CTA at every width, the dK/dV kernel walking its
rows once up to D 128 and twice past it (dV, then dK: one accumulator held
at a time), and splits its walks wherever that grid is short of a wave.
It is counted in ``flash_attention.backward_launches``, apart from the
forward's ``launches``, and f32 in ``f32_backward_launches`` too.
:func:`flash_attention_backward_plain` computes
the same gradient densely from the same statistics, for the tests and
``chip_smoke.py``.  The JAX package has no backward kernel (its model
never calls K4, and its training takes XLA's autodiff of plain ``jnp``
code), so on the CPU the Function's backward is autograd of the plain
version recomputed from the saved inputs, and on ``meta`` it charges the
backward kernel's own operations and bytes to the cost report
(``flash_attention_backward``) and returns meta gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import _build, costs

__all__ = ["MASK_VALUE", "MAX_HEAD_DIM", "flash_attention", "flash_attention_plain",
           "flash_attention_backward", "flash_attention_backward_plain", "forward_cta_rows",
           "forward_walk", "padded_width", "three_pieces", "walk_splits"]

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k, v, o, B, Sq, Sk, H, KVH, D, causal, window, scale, stats, stream
_ARGS = (_P,) * 4 + (_I,) * 8 + (ctypes.c_float, _P, _P)
# q, k, v, dO, stats, aux, dq, dk, dv, part, B, Sq, Sk, H, KVH, D, causal,
# window, splits, scale, stream
_BWD_ARGS = (_P,) * 10 + (_I,) * 9 + (ctypes.c_float, _P)
KEY_TILE = 64  # keys a forward CTA's walk counts in (flash::forward_walk)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KVH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.dtype not in _DTYPES:
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


def _operand(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (contiguous) as the kernels' 16-byte copies take it: D padded
    with zero columns to ``width``, on a 16-byte aligned buffer."""
    if x.shape[-1] != width:
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return x.clone() if x.data_ptr() % 16 else x


def three_pieces(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 pieces the f32 kernels split an f32 operand into, as
    f32 tensors: x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x − x0 − x1),
    each subtraction exact, so x0 + x1 + x2 == x (but where bf16(x) rounds
    past f32's largest value, or x2 falls below the normal range)."""
    x = x.float()
    x0 = x.bfloat16().float()
    r = x - x0
    x1 = r.bfloat16().float()
    return x0, x1, (r - x1).bfloat16().float()


def _keep(sq: int, sk: int, causal: bool, window: int, device) -> Optional[torch.Tensor]:
    """The (Sq, Sk) pairs K4's masks keep, or None without a mask."""
    if not (causal or window):
        return None
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return keep


def _scores(q, k, causal, window, scale):
    """S in f32 as the kernels form it: q scaled before the product, masked
    scores at MASK_VALUE; (B, KVH, G, Sq, Sk), with the mask."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    keep = _keep(sq, sk, causal, window, q.device)
    return (s if keep is None else s.masked_fill(~keep, MASK_VALUE)), keep


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    stats: bool = False,
):
    """K4's plain PyTorch version: one softmax over all keys at once.  With
    ``stats`` it returns ``(o, m, l)``, each row's max and denominator in
    f32 (B, H, Sq), as the kernel writes them for the backward."""
    b, sq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    s, _ = _scores(q, k, causal, window, scale)                 # (B,KVH,G,Sq,Sk)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / torch.clamp(l, min=1e-30)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    if not stats:
        return o
    return o, m.reshape(b, h, sq), l.reshape(b, h, sq)


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
    grad_out: torch.Tensor, *, causal: bool = True, window: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain PyTorch version: (dq, dk, dv) in the
    inputs' dtype, from the forward's statistics ``m``, ``l`` (B, H, Sq), in
    the kernels' arithmetic: E = exp(S − m), L = rowsum(E) (``l`` where the
    row sees no key, m = MASK_VALUE), P = E / L, dV = Pᵀ·dO, dP = dO·Vᵀ,
    Δ = rowsum(P ∘ dP) over the kept keys, dS = P ∘ (dP − Δ) (0 where
    masked), dQ = scale · dS·K, dK = dSᵀ·(scale · q).  P is normalised by
    the row sum of the E it is made of and Δ is formed from P and dP (not
    from the forward's l and the output rounded to the inputs' dtype), so a
    row that sees one key has P = 1 and dS = 0 exactly, as autograd gives,
    whatever the last bit of S.  Used by the tests and ``chip_smoke.py``,
    never on the main path."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d**-0.5 if scale is None else scale
    s, keep = _scores(q, k, causal, window, scale)
    rows = (b, kvh, g, sq, 1)
    m = m.float().reshape(rows)
    e = torch.exp(s - m)
    norm = torch.where(m == MASK_VALUE, l.float().reshape(rows), e.sum(-1, keepdim=True))
    p = e / torch.clamp(norm, min=1e-30)
    do = grad_out.float().reshape(b, sq, kvh, g, d)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    pdp = p * dp if keep is None else (p * dp).masked_fill(~keep, 0.0)
    ds = p * (dp - pdp.sum(-1, keepdim=True))
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(b, sq, kvh, g, d) * scale)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _width(q: torch.Tensor) -> int:
    """The head dim the kernels take: D, padded to a multiple of 8 for bf16
    and of 4 for f32 (16-byte chunks)."""
    chunk = 8 if q.dtype == torch.bfloat16 else 4
    return -(-q.shape[-1] // chunk) * chunk


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
            scale: float, stats: bool = False):
    """One launch of the CUDA kernel on CUDA tensors, counted: the output and,
    with ``stats``, the (2, B, H, Sq) f32 statistics (m, then l), else None."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dk = _width(q)
    q, k, v = (_operand(x, dk) for x in (q, k, v))
    out = torch.empty_like(q)
    st = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device) if stats else None
    f32 = q.dtype == torch.float32  # flash_fwd_f32_kernel
    wide = not f32 and dk > 128  # flash_fwd_bf16_wide
    library = "flash_attention_f32" if f32 else \
        "flash_attention_wide" if wide else "flash_attention"
    launch = _build.function(library, f"{library}_launch", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, sk, h, kvh, dk, int(causal), int(window),
                     float(scale), st.data_ptr() if st is not None else None, stream)
    _build.check(library, err, f"{library} launch")
    _build.count_launch(flash_attention)
    if wide:
        _build.count_launch(flash_attention, "wide_launches")
    if f32:
        _build.count_launch(flash_attention, "f32_launches")
    return (out if dk == d else out[..., :d].contiguous()), st


def padded_width(d: int) -> int:
    """The padded head width DP the backward kernels take D at, in either
    dtype."""
    return next(w for w in (64, 128, 192, 256) if d <= w)


def forward_cta_rows(d: int, bf16: bool) -> int:
    """The rows (i · G + g) a CTA of the forward kernels takes: 128 for
    ``flash_fwd_bf16_wide`` (bf16 past D 128), else 64."""
    return 128 if bf16 and d > 128 else 64


def forward_walk(first_pos: int, last_pos: int, seq_k: int, causal: bool,
                 window: int) -> Tuple[int, int]:
    """The key tiles ``[t_lo, t_end)`` (of KEY_TILE keys) a forward CTA whose
    rows sit at positions ``first_pos .. last_pos`` walks, as every forward
    kernel computes it (``flash::forward_walk`` in ``csrc/flash_tiles.cuh``):
    causal walks stop at the tile of the last row's
    diagonal; a window starts at the tile that holds the first row's
    window edge, max(0, first_pos − window + 1), except where a row sees no
    key at all (position ≥ Sk + window − 1, when Sq > Sk): that CTA walks
    from tile 0, so the row averages every key, as the TPU kernel's does."""
    t_end = -(-seq_k // KEY_TILE)
    if causal:
        t_end = min(t_end, last_pos // KEY_TILE + 1)
    t_lo = 0
    if window and last_pos < seq_k + window - 1:
        t_lo = max(0, first_pos - window + 1) // KEY_TILE
    return t_lo, t_end


def walk_splits(batch: int, seq_q: int, seq_k: int, heads: int, kv_heads: int, d: int,
                bf16: bool, sms: int) -> int:
    """The ranges each key tile's row walk is cut into in the dK/dV kernels
    that run one CTA an SM (bf16 past D 128, and f32 at every width): 1 where
    its CTAs (batch × kv head × 64 keys) fill a wave of the card's ``sms``
    SMs, else the least number that does, at most the row tiles of a kv
    head (64 rows each).  bf16 up to D 128 never splits."""
    ctas = batch * kv_heads * -(-seq_k // KEY_TILE)
    if (bf16 and d <= 128) or ctas >= sms:
        return 1
    return max(1, min(-(-sms // ctas), -(-seq_q * (heads // kv_heads) // 64)))


def flash_attention_backward(q, k, v, stats, grad_out, *, causal: bool, window: int,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call of the backward kernels on CUDA tensors (two launches on the
    stream, three with a split walk), counted once in
    ``flash_attention.backward_launches`` (and f32 in
    ``f32_backward_launches``): (dq, dk, dv) in q's dtype, from the
    forward's statistics ``stats`` (2, B, H, Sq)."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the K4 backward kernel runs on cuda, got {q.device}")
    if stats is None or stats.shape != (2, q.shape[0], q.shape[2], q.shape[1]) \
            or stats.dtype != torch.float32 or stats.device != q.device:
        raise ValueError("the K4 backward needs the forward's (2, B, H, Sq) f32 statistics")
    if grad_out.shape != q.shape or grad_out.device != q.device:
        raise ValueError(f"dO must be {tuple(q.shape)} on {q.device}, got "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dk = _width(q)
    q, k, v = (x.contiguous() for x in (q, k, v))
    g = grad_out.to(q.dtype).contiguous()
    q, k, v, g = (_operand(x, dk) for x in (q, k, v, g))
    dq, dkey, dval = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    aux = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)  # rows' statistics
    bf16 = q.dtype == torch.bfloat16
    splits = walk_splits(b, sq, sk, h, kvh, dk, bf16,
                         torch.cuda.get_device_properties(q.device).multi_processor_count)
    # the ranges' f32 sums of dK and dV, added in order by a last launch
    part = torch.empty((splits, 2, b, sk, kvh, padded_width(dk)), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    stats = stats.contiguous()
    library = "flash_attention_bwd" if bf16 else "flash_attention_f32_bwd"
    launch = _build.function(library, "flash_attention_backward_launch" if bf16 else
                             "flash_attention_f32_backward_launch", _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), stats.data_ptr(),
                     aux.data_ptr(), dq.data_ptr(), dkey.data_ptr(), dval.data_ptr(),
                     part.data_ptr() if part is not None else None,
                     b, sq, sk, h, kvh, dk, int(causal), int(window), splits, float(scale),
                     stream)
    _build.check(library, err, "flash_attention backward launch")
    _build.count_launch(flash_attention, "backward_launches")
    if not bf16:
        _build.count_launch(flash_attention, "f32_backward_launches")
    if dk != d:
        dq, dkey, dval = (x[..., :d].contiguous() for x in (dq, dkey, dval))
    return dq, dkey, dval


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


def _priced_backward(q, k, v, causal: bool, window: int):
    """The meta route of the backward: the backward kernels' own cost
    charged to the active cost report, meta gradients, no launch."""
    from .ops import backward_flops, backward_hbm_bytes, window_share

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    flops = backward_flops(b, sq, sk, h, d, causal=causal, bf16=q.dtype == torch.bfloat16) * \
        window_share(sq, sk, causal, window)
    costs.charge("flash_attention_backward", flops,
                 backward_hbm_bytes(b, sq, sk, h, kvh, d, bytes_per_el=q.element_size()))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _FlashAttention(torch.autograd.Function):
    """K4 with a gradient.  On the card: the forward kernel (with its
    statistics when a gradient is wanted) and the backward kernel.  On the
    CPU: the plain version, and autograd of it recomputed from the saved
    q, k, v.  On ``meta``: both priced."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float, stats: bool):
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return flash_attention_plain(q, k, v, **ctx.mask)
        if q.device.type == "meta":
            ctx.save_for_backward(q, k, v)
            return _priced(q, k, causal, window)
        out, st = _launch(q, k, v, causal, window, scale, stats=stats)
        ctx.save_for_backward(q, k, v, st)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        q, k, v = saved[:3]
        if q.device.type == "cuda":
            grads = flash_attention_backward(q, k, v, saved[3], grad_out, **ctx.mask)
        elif q.device.type == "meta":
            grads = _priced_backward(q, k, v, ctx.mask["causal"], ctx.mask["window"])
        else:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(n) for x, n in zip((q, k, v), need)]
                out = flash_attention_plain(*leaves, **ctx.mask)
                grads = iter(torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                                 grad_out))
            grads = [next(grads) if n else None for n in need]
        return tuple(gr if n else None for gr, n in zip(grads, need)) + (None,) * 4


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention forward through K4; returns (B, Sq, H, D) in q's dtype,
    differentiable in q, k and v."""
    _check(q, k, v)
    scale = q.shape[-1]**-0.5 if scale is None else scale
    # the statistics only where a backward can follow: serving writes none
    stats = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, scale, stats)


flash_attention.launches = 0
flash_attention.wide_launches = 0   # those of flash_fwd_bf16_wide, within ``launches``
flash_attention.f32_launches = 0    # those of flash_fwd_f32_kernel, within ``launches``
flash_attention.backward_launches = 0
flash_attention.f32_backward_launches = 0  # the f32 backward's, within ``backward_launches``

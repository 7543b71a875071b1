"""Public entry for K4 and the analytic traffic and operation counts.

``flash_attention`` is the public entry (any ``Sq`` and ``Sk``: the
kernel masks ragged tiles, so no shape goes to the oracle).
``kernel_hbm_bytes`` is the traffic of the kernel by construction — Q, K,
V read once, O written once — and ``kernel_flops`` its multiply-adds, as
in ``repro.kernels.flash_attention.ops``; the bound on the card is the
larger of the two over the card's peak rates.
"""

from __future__ import annotations

import functools

from .flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_plain,
    flash_attention_plain, padded_width, walk_splits,
)
from .ref import mha_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_backward",
           "flash_attention_backward_plain", "mha_ref", "kernel_hbm_bytes", "kernel_flops",
           "backward_flops", "backward_hbm_bytes", "attended_pairs", "window_share",
           "F32_PIECE_PRODUCTS", "tensor_core_flops"]

# the bf16 products that make one f32 product on the tensor cores: three
# pieces a side, the pairs whose piece indices sum to at most 2
F32_PIECE_PRODUCTS = 6


def kernel_hbm_bytes(
    batch: int, sq: int, sk: int, heads: int, kv_heads: int, head_dim: int,
    *, bytes_per_el: int = 2, backward: bool = False,
) -> float:
    """Device-memory traffic by construction: forward reads Q, K, V and
    writes O; backward re-reads Q, K, V, O, dO and writes dQ, dK, dV."""
    q_b = batch * sq * heads * head_dim * bytes_per_el
    kv_b = 2 * batch * sk * kv_heads * head_dim * bytes_per_el
    o_b = q_b
    fwd = q_b + kv_b + o_b
    if not backward:
        return fwd
    bwd = (2 * q_b + kv_b) + (q_b + kv_b)  # reads (Q,K,V,O,dO) + writes (dQ,dK,dV)
    return fwd + bwd


def kernel_flops(
    batch: int, sq: int, sk: int, heads: int, head_dim: int,
    *, causal: bool = True, backward: bool = False,
) -> float:
    """2·(QKᵀ) + 2·(PV) per head, halved when causal masking skips the
    upper triangle."""
    full = 2.0 * 2.0 * batch * heads * sq * sk * head_dim
    if causal and sq == sk:
        full *= 0.5
    return full * (3.5 if backward else 1.0)


def backward_flops(batch: int, sq: int, sk: int, heads: int, head_dim: int, *,
                   causal: bool = True, bf16: bool = False) -> float:
    """The backward kernels' own multiply-adds (×2), in tile products of the
    forward's size, for each (64-row tile, key tile) pair the walks visit:
    three walks of the rows forming S; S and dP; S, dP and dS·K; and the
    dK/dV walk forming Sᵀ, dPᵀ, Pᵀ·dO and dSᵀ·Q: 10 where the forward has
    2, 5 × ``kernel_flops``.  In bf16 P and dS enter their three products
    as two operands each (value and remainder): 13, 6.5 ×.  Past D 128 in
    bf16 they enter as one operand, and the dK/dV kernel's two warpgroups
    each form the whole Sᵀ and dPᵀ (and half of dV and dK): 12, 6 ×.  The
    f32 kernels form the same 10 up to D 64; past it their dK/dV kernel
    walks its rows twice (Sᵀ and Pᵀ·dO; dPᵀ, Sᵀ and dSᵀ·Q): 11, 5.5 ×; each
    f32 product is ``F32_PIECE_PRODUCTS`` bf16 products on the tensor
    cores (:func:`tensor_core_flops`).  ``kernel_flops(backward=True)`` counts the
    2.5 × of a backward that forms S and dP once: the least work, which
    bounds it."""
    products = (12 if head_dim > 128 else 13) if bf16 else (10 if head_dim <= 64 else 11)
    return products / 2 * kernel_flops(batch, sq, sk, heads, head_dim, causal=causal)


def tensor_core_flops(flops: float, bf16: bool) -> float:
    """The tensor cores' multiply-adds (×2) that run ``flops`` of K4's
    products: bf16 as they are; f32 as ``F32_PIECE_PRODUCTS`` bf16 products
    of three-piece operands each (``three_pieces``), what the f32 kernels'
    bound is priced at (the bf16 peak)."""
    return flops if bf16 else F32_PIECE_PRODUCTS * flops


def backward_hbm_bytes(batch: int, sq: int, sk: int, heads: int, kv_heads: int, head_dim: int,
                       *, bytes_per_el: int = 2, scratch: bool = True) -> float:
    """The backward's traffic by construction: Q, K, V and dO read once, dQ,
    dK and dV written once, the forward's f32 row statistics m and l read,
    and with ``scratch`` the kernels' own: the rows' statistics for the
    dK/dV kernel written and read (bf16, the ``wgmma`` kernels: m·log₂e,
    1 / L and Δ, 8 planes of (B, H, Sq) in all; f32: L and Δ, 6), and where
    the bf16 dK/dV grid past D 128 is short of a wave of the H100 SXM's SMs
    (``walk_splits``), its ranges' f32 sums of dK and dV written and read
    once more.  Without ``scratch``: the least bytes, which bound it."""
    from ...launch.mesh import H100_SXM

    q_b = batch * sq * heads * head_dim * bytes_per_el
    kv_b = 2 * batch * sk * kv_heads * head_dim * bytes_per_el
    io = 2 * (2 * q_b + kv_b)
    if not scratch:
        return io + 2 * 4 * batch * heads * sq
    bf16 = bytes_per_el == 2
    planes = 8 if bf16 else 6
    splits = walk_splits(batch, sq, sk, heads, kv_heads, head_dim, bf16, H100_SXM.sms)
    part = 0 if splits == 1 else \
        splits * 2 * batch * sk * kv_heads * padded_width(head_dim) * 4
    return io + planes * 4 * batch * heads * sq + 2 * part


@functools.lru_cache(maxsize=None)
def attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs K4's masks keep: key j <= query i when causal,
    and j > i - window when windowed."""
    total = 0
    for i in range(sq):
        hi = min(i + 1, sk) if causal else sk
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def window_share(sq: int, sk: int, causal: bool, window: int) -> float:
    """The share of the causal pairs a window keeps (1 without one): what
    scales ``kernel_flops`` for a windowed call."""
    if not window:
        return 1.0
    return attended_pairs(sq, sk, causal, window) / max(attended_pairs(sq, sk, causal, 0), 1)

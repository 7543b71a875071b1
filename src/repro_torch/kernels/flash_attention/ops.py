"""Public entry for K4 and the analytic traffic and operation counts.

``flash_attention`` is the public entry (any ``Sq`` and ``Sk``: the
kernel masks ragged tiles, so no shape goes to the oracle).
``kernel_hbm_bytes`` is the traffic of the kernel by construction — Q, K,
V read once, O written once — and ``kernel_flops`` its multiply-adds, as
in ``repro.kernels.flash_attention.ops``; the bound on the card is the
larger of the two over the card's peak rates.
"""

from __future__ import annotations

from .flash_attention import flash_attention, flash_attention_plain
from .ref import mha_ref

__all__ = ["flash_attention", "flash_attention_plain", "mha_ref", "kernel_hbm_bytes",
           "kernel_flops"]


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

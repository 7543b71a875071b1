"""Public entry for K5 and its analytic traffic and operation counts."""

from __future__ import annotations

from .ssd_scan import ssd_scan, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "kernel_hbm_bytes", "kernel_flops"]


def kernel_hbm_bytes(batch: int, seq: int, heads: int, head_dim: int, state: int, *,
                     with_h0: bool = False) -> float:
    """x, log_a, B, C (and h0) read once, y and the final state written once (f32)."""
    x_b = batch * seq * heads * head_dim * 4
    la_b = batch * seq * heads * 4
    bc_b = 2 * batch * seq * state * 4
    h_b = batch * heads * head_dim * state * 4
    return 2 * x_b + la_b + bc_b + h_b * (2 if with_h0 else 1)


def kernel_flops(batch: int, seq: int, heads: int, head_dim: int, state: int) -> float:
    """Least operations (multiply-adds ×2) of the function on this sequence.

    The output does not depend on the chunk length, so this counts the
    chunked algorithm at the chunk length q that needs the fewest: per
    chunk C·Bᵀ on the lower triangle (shared by the heads), and per head
    the masked product with x, C·hᵀ, the state update and the state's
    decay.  Per token that is about 4·H·P·N plus (q + 1)·H·P + H·P·N / q,
    least near q = √N; the caller's chunk (256 in mamba2) would add a
    quadratic term the function does not need.
    """
    def chunk_flops(q: int) -> float:
        tri = q * (q + 1) / 2
        return (2.0 * tri * state                                    # C·Bᵀ
                + heads * (2.0 * tri * head_dim                      # (C·Bᵀ ⊙ L)·x
                           + 4.0 * q * head_dim * state              # C·hᵀ, state update
                           + head_dim * state))                      # exp(cs_Q)·h

    def total(q: int) -> float:
        full, rest = divmod(seq, q)
        return full * chunk_flops(q) + (chunk_flops(rest) if rest else 0.0)

    return batch * min(total(q) for q in range(1, max(seq, 1) + 1))

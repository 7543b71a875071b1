"""Public entry for K5 and its analytic traffic and operation counts."""

from __future__ import annotations

import functools

from .ssd_scan import SUB, ssd_scan, ssd_scan_backward, ssd_scan_backward_plain, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_backward", "ssd_scan_backward_plain",
           "kernel_hbm_bytes", "kernel_flops", "backward_flops", "backward_hbm_bytes"]


def kernel_hbm_bytes(batch: int, seq: int, heads: int, head_dim: int, state: int, *,
                     with_h0: bool = False) -> float:
    """x, log_a, B, C (and h0) read once, y and the final state written once (f32)."""
    x_b = batch * seq * heads * head_dim * 4
    la_b = batch * seq * heads * 4
    bc_b = 2 * batch * seq * state * 4
    h_b = batch * heads * head_dim * state * 4
    return 2 * x_b + la_b + bc_b + h_b * (2 if with_h0 else 1)


@functools.lru_cache(maxsize=None)
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


def backward_hbm_bytes(batch: int, seq: int, heads: int, head_dim: int, state: int, *,
                       with_h0: bool = False) -> float:
    """The backward's traffic by construction (f32): x, log_a, B, C, dy, the
    final state's gradient (and h0) read once; dx, dlog_a, dB, dC (and dh0)
    written once."""
    x_b = batch * seq * heads * head_dim * 4
    la_b = batch * seq * heads * 4
    bc_b = 2 * batch * seq * state * 4
    h_b = batch * heads * head_dim * state * 4
    return 2 * (x_b + la_b + bc_b) + x_b + h_b * (3 if with_h0 else 1)


def backward_flops(batch: int, seq: int, heads: int, head_dim: int, state: int) -> float:
    """The backward kernels' own multiply-adds (×2), per sub-chunk of
    ``SUB`` steps (the last one padded) and head: the forward's state
    contributions and their pass again (2·Q·P·N + 2·P·N), the same for
    dy·Cᵀ and the gradient's pass; ``ssd_bwd_kernel``'s dy·xᵀ and
    (G ⊙ L)ᵀ·dy (2·Q²·P each), B·dh_outᵀ and C·h_inᵀ (2·Q·P·N each);
    ``ssd_bwd_bc_kernel``'s dy·xᵀ again for each 64 columns of N (2·Q²·P
    each), M·B and Mᵀ·C (2·Q²·N each), dy·h_in and x·dh_out (2·Q·P·N
    each); and C·Bᵀ once a sub-chunk (2·Q²·N)."""
    q, p, n = SUB, head_dim, state
    slabs = -(-n // q)
    per_head = (2 * (2 * q * p * n + 2 * p * n) + 2 * (2 * q * q * p) + 4 * (2 * q * p * n)
                + slabs * (2 * q * q * p) + 2 * (2 * q * q * n))
    return float(batch * -(-seq // q) * (heads * per_head + 2 * q * q * n))

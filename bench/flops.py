"""The least work of a training step and of each kernel call, and the card's peaks.

Frozen with the benchmark: the program's own cost functions are never
imported.  Every count is of what the mathematics needs, not of what an
implementation does: no padding of the head dim, no recomputation, each
input read once and each output written once.

* ``k4_*``: attention (K4).  The forward's least work is QKᵀ and P·V, 2 + 2
  flops a (query, key, dim) triple, halved when causal; its least bytes
  are Q, K, V read and O and one float32 log-sum-exp a row and head
  written.  The backward's least work is 2.5 × the forward's (FA2's:
  S recomputed once, dV, dP, dQ, dK), its least bytes Q, K, V, O, dO and
  the log-sum-exp read and dQ, dK, dV written.  The forward's flops are
  the formula of ``kernel_flops`` in the port's K4 ``ops.py``, copied.
* ``k5_*``: the chunked SSD scan (K5).  The forward's least flops are
  those of the chunked algorithm at the chunk length that needs the
  fewest (the port's K5 ``kernel_flops``, copied); its least bytes are x,
  log_a, B, C read and y and the final state written, in float32.  The
  backward's least work is 2 × the forward's (each product's gradient
  with respect to each of its two operands); its least bytes x, log_a, B,
  C and dy read and dx, dlog_a, dB, dC written.
* :func:`model_flops`: a training step's model FLOPs: 6 × the weights
  that multiply activations × the tokens (the input embedding lookup
  excluded, a tied head counted once), plus 3 × the forward's least
  work of attention (QKᵀ and P·V, causal half) and of the SSD scan.
  Recomputation is not counted.  The family (``families/<family>.py``)
  gives its layers' weights a token is multiplied by (``matmul_weights``)
  and their attention's or scan's least forward work (``mixer_flops``).
* ``conv_*``: the depthwise causal conv (its bias, and SiLU where the
  block applies it).  The forward's least bytes are x and the weights
  read and y written, its least work the conv's multiply-adds; the
  backward's least bytes x, dy and the weights read and dx, dw and db
  written, its least work those of dx and dw.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

from . import families
from .reference.model import padded_vocab

__all__ = ["H100", "least_seconds", "k4_forward", "k4_backward", "k5_forward",
           "k5_backward", "conv_forward", "conv_backward", "matmul_weights", "model_flops",
           "k4_calls", "k5_calls"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
H100 = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the time the bf16 tensor-core peak and the HBM
    bandwidth allow."""
    return max(flops / H100["bf16_flops"], nbytes / H100["hbm_bytes"])


def k4_forward(b: int, sq: int, sk: int, heads: int, kv_heads: int, d: int, *,
               causal: bool = True, bytes_per_el: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one attention forward at these shapes."""
    flops = 2.0 * 2.0 * b * heads * sq * sk * d
    if causal and sq == sk:
        flops *= 0.5
    q = b * sq * heads * d * bytes_per_el
    kv = 2 * b * sk * kv_heads * d * bytes_per_el
    lse = b * heads * sq * 4
    return flops, float(q + kv + q + lse)


def k4_backward(b: int, sq: int, sk: int, heads: int, kv_heads: int, d: int, *,
                causal: bool = True, bytes_per_el: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one attention backward at these shapes."""
    flops, _ = k4_forward(b, sq, sk, heads, kv_heads, d, causal=causal,
                          bytes_per_el=bytes_per_el)
    q = b * sq * heads * d * bytes_per_el
    kv = 2 * b * sk * kv_heads * d * bytes_per_el
    lse = b * heads * sq * 4
    reads = 3 * q + kv + lse        # Q, O, dO, K, V, the log-sum-exp
    writes = q + kv                 # dQ, dK, dV
    return 2.5 * flops, float(reads + writes)


@functools.lru_cache(maxsize=None)
def _ssd_flops(b: int, s: int, heads: int, p: int, n: int) -> float:
    def chunk_flops(q: int) -> float:
        tri = q * (q + 1) / 2
        return (2.0 * tri * n                                  # C·Bᵀ, shared by the heads
                + heads * (2.0 * tri * p                       # (C·Bᵀ ⊙ L)·x
                           + 4.0 * q * p * n                   # C·hᵀ, the state update
                           + p * n))                           # the state's decay

    def total(q: int) -> float:
        full, rest = divmod(s, q)
        return full * chunk_flops(q) + (chunk_flops(rest) if rest else 0.0)

    return b * min(total(q) for q in range(1, max(s, 1) + 1))


def k5_forward(b: int, s: int, heads: int, p: int, n: int) -> Tuple[float, float]:
    """(flops, bytes) of one SSD scan forward (float32 operands)."""
    x = b * s * heads * p * 4
    la = b * s * heads * 4
    bc = 2 * b * s * n * 4
    h = b * heads * p * n * 4
    return _ssd_flops(b, s, heads, p, n), float(2 * x + la + bc + h)


def k5_backward(b: int, s: int, heads: int, p: int, n: int) -> Tuple[float, float]:
    """(flops, bytes) of one SSD scan backward (float32 operands)."""
    flops, _ = k5_forward(b, s, heads, p, n)
    x = b * s * heads * p * 4
    la = b * s * heads * 4
    bc = 2 * b * s * n * 4
    return 2.0 * flops, float(2 * (2 * x + la + bc) - x)   # x, dy, la, B, C in; dx, dla, dB, dC out


def conv_forward(b: int, s: int, c: int, w: int, *, bytes_per_el: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one depthwise causal conv forward of width ``w``
    over (b, s, c) activations."""
    return 2.0 * b * s * c * w, float((2 * b * s * c + (w + 1) * c) * bytes_per_el)


def conv_backward(b: int, s: int, c: int, w: int, *, bytes_per_el: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one depthwise causal conv backward: dx, dw and db."""
    return 4.0 * b * s * c * w, float((3 * b * s * c + 2 * (w + 1) * c) * bytes_per_el)


def matmul_weights(m: Dict) -> int:
    """The weights of the model of ``m`` (a configuration's ``model``
    group) that multiply a token's activations: its family's layers'
    (every projection, the SSD block's depthwise conv; of routed experts
    those a token is sent to) and the head (a tied table counted once, as
    the head); not the input embedding lookup, the norms, biases or
    per-head scalars."""
    return families.load(m["family"]).matmul_weights(m) + padded_vocab(m) * m["d_model"]


def k4_calls(m: Dict, rows: int, seq: int) -> Tuple[int, int, int, int, int, int]:
    """(b, sq, sk, heads, kv_heads, d) of each K4 call of a microbatch of
    ``rows`` × ``seq`` tokens (causal self-attention)."""
    return rows, seq, seq, m["num_heads"], m["num_kv_heads"], m["head_dim"]


def k5_calls(m: Dict, rows: int, seq: int) -> Tuple[int, int, int, int, int]:
    """(b, s, heads, head_dim, state) of each K5 call of a microbatch."""
    di = m["ssm_expand"] * m["d_model"]
    return rows, seq, di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"]


def model_flops(m: Dict, rows: int, seq: int) -> float:
    """Model FLOPs of a training step over ``rows`` × ``seq`` tokens."""
    return (6.0 * matmul_weights(m) * rows * seq
            + 3.0 * families.load(m["family"]).mixer_flops(m, rows, seq))

"""The least-work arithmetic against counts by hand, at the cells' shapes."""

import pytest

from tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from bench import families, flops
from bench.harness import load_cell


def test_k4_at_the_stablelm_microbatch():
    # 2 rows × 4096, 32 query and 8 kv heads of 160, causal, bf16
    f, b = flops.k4_forward(2, 4096, 4096, 32, 8, 160)
    assert f == 2 * 2 * 2 * 32 * 4096 * 4096 * 160 / 2 == 343597383680
    q = 2 * 4096 * 32 * 160 * 2          # 83,886,080 bytes, and O as many
    kv = 2 * 2 * 4096 * 8 * 160 * 2      # 41,943,040
    lse = 2 * 32 * 4096 * 4              # 1,048,576
    assert b == 2 * q + kv + lse == 210763776
    fb, bb = flops.k4_backward(2, 4096, 4096, 32, 8, 160)
    assert fb == 2.5 * f and bb == 3 * q + kv + lse + q + kv
    assert flops.least_seconds(f, b) == pytest.approx(f / 989e12)    # compute-bound


def test_k5_by_hand_at_a_tiny_shape():
    # s = 2, one head of P = N = 1: at q = 1, 2 chunks of (2·1 + (2·1 + 4 + 1)) = 9 → 18;
    # at q = 2, one chunk of (2·3 + (2·3 + 8 + 1)) = 21; the least is 18
    assert flops.k5_forward(1, 2, 1, 1, 1)[0] == 18.0


def test_k5_at_the_mamba2_microbatch():
    b, s, h, p, n = 32, 2048, 24, 64, 128
    f, by = flops.k5_forward(b, s, h, p, n)

    def chunked(q):   # the same count, written per token: C·Bᵀ, (CBᵀ⊙L)·x, C·hᵀ and update, decay
        full, rest = divmod(s, q)
        per = lambda q: q * (q + 1) * n + h * (q * (q + 1) * p + 4 * q * p * n + p * n)
        return b * (full * per(q) + (per(rest) if rest else 0))

    assert f == min(chunked(q) for q in range(1, s + 1)) < chunked(64) < chunked(256)
    x = b * s * h * p * 4
    assert by == 2 * x + b * s * h * 4 + 2 * b * s * n * 4 + b * h * p * n * 4 == 903872512
    fb, bb = flops.k5_backward(b, s, h, p, n)
    assert fb == 2 * f and bb == 3 * x + 2 * b * s * h * 4 + 4 * b * s * n * 4
    assert flops.least_seconds(f, by) == pytest.approx(by / 3.35e12)  # memory-bound


def test_model_flops_of_the_two_cells():
    stablelm = load_cell("train.stablelm-12b.s4096")["config"]["model"]
    per_layer = 5120 * 5120 * 2 + 5120 * 1280 * 2 + 3 * 5120 * 13824
    assert flops.matmul_weights(stablelm) == 4 * per_layer + 100352 * 5120 == 1625292800
    attn = 3 * 4 * (2 * 2 * 4 * 32 * 4096 * 4096 * 160 / 2)
    assert flops.model_flops(stablelm, 4, 4096) == 6 * 1625292800 * 16384 + attn
    mamba = load_cell("train.mamba2-130m.s2048")["config"]["model"]
    per_layer = 768 * (2 * 1536 + 2 * 128 + 24) + 4 * (1536 + 256) + 1536 * 768
    assert flops.matmul_weights(mamba) == 24 * per_layer + 50432 * 768 == 128999424
    ssd = 3 * 24 * flops.k5_forward(32, 2048, 24, 64, 128)[0]
    assert flops.model_flops(mamba, 32, 2048) == 6 * 128999424 * 65536 + ssd


def test_conv_at_the_mamba2_microbatch():
    # 32 rows x 2048 of xBC (1536 + 2 x 128 channels), width 4, bf16
    mamba = load_cell("train.mamba2-130m.s2048")["config"]["model"]
    assert families.load("ssm").conv_calls(mamba, 32, 2048) == (32, 2048, 1792, 4)
    value = 32 * 2048 * 1792 * 2         # 234,881,024 bytes of x, of y, of dy, of dx
    f, b = flops.conv_forward(32, 2048, 1792, 4)
    assert f == 2 * 4 * 32 * 2048 * 1792 and b == 2 * value + 5 * 1792 * 2 == 469779968
    fb, bb = flops.conv_backward(32, 2048, 1792, 4)
    assert fb == 2 * f and bb == 3 * value + 2 * 5 * 1792 * 2 == 704678912
    assert flops.least_seconds(f, b) == pytest.approx(b / 3.35e12)   # memory-bound

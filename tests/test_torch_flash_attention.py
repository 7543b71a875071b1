"""K4's plain version (the CPU path of the port's flash attention) against
the JAX package: ``flash_attention`` (the Pallas kernel in interpret mode)
and the ``mha_ref`` oracle, on the same numpy-seeded inputs, at the
tolerances of ``tests/test_kernels.py`` (f32 rtol 2e-4 / atol 2e-5, bf16
2e-2)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

SHAPES = [  # b, sq, h, kvh, d, causal, window: test_kernels.py's five, then ragged
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 8, 1, 16, True, 0),     # MQA
    (2, 128, 4, 4, 64, False, 0),    # MHA non-causal
    (1, 256, 4, 2, 32, True, 64),    # local window
    (1, 128, 2, 2, 128, True, 0),    # wide head
    (1, 100, 4, 2, 32, True, 0),     # ragged Sq: no 64-row tiling
    (2, 77, 6, 3, 16, True, 9),      # ragged, odd group count, window
]


def inputs(b, sq, sk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32))


def to_np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("b,sq,h,kvh,d,causal,window", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(b, sq, h, kvh, d, causal, window):
    qn, kn, vn = inputs(b, sq, sq, h, kvh, d, seed=sq + d)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    before = fk.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fk.flash_attention.launches == before  # CPU tensors take the plain version
    jq, jk, jv = map(jnp.asarray, (qn, kn, vn))
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                       q_block=64, kv_block=64)
    want_ref = jax_mha_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), to_np(want_kernel), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), to_np(want_ref), **F32_TOL)
    np.testing.assert_allclose(mha_ref(q, k, v, causal=causal, window=window).numpy(),
                               to_np(want_ref), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_sweep(dtype):
    qn, kn, vn = inputs(1, 128, 128, 4, 2, 32, seed=5)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = fk.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (qn, kn, vn)))
    assert got.dtype == tdt
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)),
                                q_block=64, kv_block=64)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@pytest.mark.parametrize("sq,sk,causal", [(37, 200, False), (37, 200, True), (130, 65, True)])
def test_cross_lengths_match_oracle(sq, sk, causal):
    # Sq != Sk with top-left causal alignment, as the kernel and oracle define it
    qn, kn, vn = inputs(2, sq, sk, 4, 2, 16, seed=sq)
    got = fk.flash_attention(*map(torch.from_numpy, (qn, kn, vn)), causal=causal)
    want = jax_mha_ref(*map(jnp.asarray, (qn, kn, vn)), causal=causal)
    np.testing.assert_allclose(got.numpy(), to_np(want), **F32_TOL)


def test_fully_masked_rows_average_values_as_the_kernel_does():
    # window 1 without causal masking keeps k > q - 1, so query rows past the
    # last key see none: the kernel's finite mask value averages V there,
    # where the -inf oracle would give NaN
    qn, kn, vn = inputs(1, 8, 4, 2, 2, 16, seed=3)
    got = fk.flash_attention_plain(*map(torch.from_numpy, (qn, kn, vn)), causal=False, window=1)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[0, 6].numpy(), vn[0].mean(axis=0), rtol=1e-5, atol=1e-6)


def test_traffic_and_flop_models_match_reference():
    args = (1, 4096, 4096, 32, 8, 128)
    assert ops.kernel_hbm_bytes(*args) == jops.kernel_hbm_bytes(*args)
    assert ops.kernel_hbm_bytes(*args, backward=True) == jops.kernel_hbm_bytes(*args, backward=True)
    for causal in (True, False):
        assert ops.kernel_flops(2, 2048, 2048, 32, 64, causal=causal) == \
            jops.kernel_flops(2, 2048, 2048, 32, 64, causal=causal)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        fk.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        fk.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fk.flash_attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))

"""K5's plain version (the CPU path of the port's SSD scan) against the JAX
package: ``ssd_scan`` (the Pallas kernel in interpret mode) and the model's
``_ssd_chunked`` oracle, on the same numpy-seeded inputs, at the 2e-4 of
``tests/test_kernel_ssd.py``; with ragged lengths and a carried state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    log_a = (-0.2 * rng.random((b, s, h))).astype(np.float32)   # decays in [-0.2, 0)
    bm = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((b, s, n))).astype(np.float32)
    return x, log_a, bm, cm


def both(arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 8, 16, 32),
    (1, 96, 1, 32, 32, 32),
])
def test_plain_matches_jax_kernel_and_oracle(b, s, h, p, n, chunk):
    (x, la, bm, cm), jargs = both(inputs(b, s, h, p, n, seed=s))
    before = sk.ssd_scan.launches
    y, hf = ops.ssd_scan(x, la, bm, cm, chunk=chunk)
    assert sk.ssd_scan.launches == before  # CPU tensors take the plain version
    for y_want, h_want in (jax_ssd_scan(*jargs, chunk=chunk), _ssd_chunked(*jargs, chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(h_want), **TOL)


@pytest.mark.parametrize("s,chunk", [(100, 32), (37, 16), (5, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ragged_and_carried_state_match_oracle(s, chunk, with_h0):
    b, h, p, n = 2, 3, 8, 16
    (x, la, bm, cm), jargs = both(inputs(b, s, h, p, n, seed=s))
    h0n = (0.5 * np.random.default_rng(7).standard_normal((b, h, p, n))).astype(np.float32) \
        if with_h0 else None
    y, hf = ops.ssd_scan(x, la, bm, cm, chunk=chunk,
                         h0=torch.from_numpy(h0n) if with_h0 else None)
    y_want, h_want = _ssd_chunked(*jargs, chunk, jnp.asarray(h0n) if with_h0 else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_want), **TOL)


def test_split_sequence_carries_state():
    """Two calls, the second carrying the first's final state, equal one call."""
    (x, la, bm, cm), _ = both(inputs(1, 80, 2, 8, 16, seed=11))
    y, hf = ops.ssd_scan(x, la, bm, cm, chunk=16)
    y1, h1 = ops.ssd_scan(x[:, :45], la[:, :45], bm[:, :45], cm[:, :45], chunk=16)
    y2, h2 = ops.ssd_scan(x[:, 45:], la[:, 45:], bm[:, 45:], cm[:, 45:], chunk=16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **TOL)
    torch.testing.assert_close(h2, hf, **TOL)


def test_chunk_invariance():
    (x, la, bm, cm), _ = both(inputs(1, 64, 2, 8, 8, seed=3))
    y16, _ = ops.ssd_scan(x, la, bm, cm, chunk=16)
    y32, _ = ops.ssd_scan(x, la, bm, cm, chunk=32)
    torch.testing.assert_close(y16, y32, **TOL)


def test_counts_and_wrapper_checks():
    # at least the state update and the C·h readout (4·S·H·P·N), at most
    # the per-token recurrence (5·S·H·P·N); the caller's chunk plays no part
    readout = 4.0 * 512 * 24 * 64 * 128
    assert readout < ops.kernel_flops(1, 512, 24, 64, 128) < 1.25 * readout
    assert ops.kernel_hbm_bytes(1, 512, 24, 64, 128, with_h0=True) > \
        ops.kernel_hbm_bytes(1, 512, 24, 64, 128)
    (x, la, bm, cm), _ = both(inputs(1, 16, 2, 8, 8))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, la[:, :8], bm, cm, chunk=8)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, la, bm, cm, chunk=8, h0=torch.zeros(1, 2, 8, 4))

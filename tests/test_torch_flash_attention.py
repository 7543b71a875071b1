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

SHAPES = [  # b, sq, sk, h, kvh, d, causal, window: test_kernels.py's five, then ragged
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 256, 256, 8, 1, 16, True, 0),     # MQA
    (2, 128, 128, 4, 4, 64, False, 0),    # MHA non-causal
    (1, 256, 256, 4, 2, 32, True, 64),    # local window
    (1, 128, 128, 2, 2, 128, True, 0),    # wide head
    (1, 100, 100, 4, 2, 32, True, 0),     # ragged Sq: no 64-row tiling
    (2, 77, 77, 6, 3, 16, True, 9),       # ragged, odd group count, window
    # head dims the card pads to wider tiles: the smoke configs' 8, 24, 80,
    # stablelm-12b's 160 and recurrentgemma-9b's 256
    (1, 70, 70, 4, 2, 8, True, 0),
    (1, 100, 100, 4, 2, 24, True, 0),
    (1, 128, 128, 2, 1, 80, False, 0),
    (1, 128, 128, 4, 1, 160, True, 0),
    (1, 130, 130, 2, 1, 256, True, 64),
    # the wide bf16 kernel's widths with a window and Sq > Sk: the last rows
    # see no key (position >= Sk + window - 1) and average every key, as
    # the Pallas kernel's rows do (the -inf oracle gives NaN there)
    (1, 192, 128, 4, 2, 200, True, 40),
    (1, 256, 128, 2, 1, 256, True, 64),
    (1, 192, 64, 2, 2, 200, False, 30),
    (1, 128, 128, 4, 1, 256, False, 50),
]


def shape_id(shape):
    """The test id: pytest's own for Sq == Sk (the ids these cases had
    before Sk joined them), ``Sq x Sk`` otherwise."""
    b, sq, sk, *rest = shape
    return "-".join(map(str, (b, sq if sq == sk else f"{sq}x{sk}", *rest)))


def inputs(b, sq, sk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32))


def to_np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", SHAPES, ids=map(shape_id, SHAPES))
def test_plain_matches_jax_kernel_and_oracle(b, sq, sk, h, kvh, d, causal, window):
    qn, kn, vn = inputs(b, sq, sk, h, kvh, d, seed=sq + d)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    before = fk.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fk.flash_attention.launches == before  # CPU tensors take the plain version
    jq, jk, jv = map(jnp.asarray, (qn, kn, vn))
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                       q_block=64, kv_block=64)
    want_ref = jax_mha_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), to_np(want_kernel), **F32_TOL)
    keep = fk._keep(sq, sk, causal, window, "cpu")
    seen = np.ones(sq, bool) if keep is None else keep.any(1).numpy()  # rows that see a key
    np.testing.assert_allclose(got.numpy()[:, seen], to_np(want_ref)[:, seen], **F32_TOL)
    np.testing.assert_allclose(mha_ref(q, k, v, causal=causal, window=window).numpy()[:, seen],
                               to_np(want_ref)[:, seen], **F32_TOL)
    if not seen.all():  # a row that sees no key averages every key
        np.testing.assert_allclose(got.numpy()[:, ~seen],
                                   np.repeat(vn.mean(1), h // kvh, axis=1)[:, None]
                                   .repeat((~seen).sum(), axis=1), rtol=1e-5, atol=1e-6)


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


def p_rounded_to_bf16(q, k, v, *, causal, window):
    """K4's bf16 tensor-core arithmetic on the CPU: f32 scores of the bf16
    inputs, scaled after the product, max, exp and l in f32; only P is
    rounded to bf16 before P·V."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d**-0.5
    qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    s = s.masked_fill(~keep, fk.MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), v.float()) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).bfloat16()


@pytest.mark.parametrize("b,s,h,kvh,d,causal,window", [
    (1, 1000, 32, 4, 64, True, 0),    # tinyllama's heads, ragged length
    (1, 891, 40, 8, 128, True, 0),    # qwen3-14b's heads (G = 5) at the longest served prompt
    (1, 77, 6, 3, 16, True, 9),       # ragged everything, window
])
def test_bf16_p_rounding_stays_within_bf16_tolerance(b, s, h, kvh, d, causal, window):
    # the tensor-core kernel rounds P to bf16 before P·V and keeps the rest
    # in f32; that alone must stay within the bf16 tolerance of the plain
    # version and of the JAX oracle
    qn, kn, vn = inputs(b, s, s, h, kvh, d, seed=s + d)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    got = p_rounded_to_bf16(q, k, v, causal=causal, window=window)
    plain = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(plain), **BF16_TOL)
    want = jax_mha_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (qn, kn, vn)),
                       causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **BF16_TOL)


def pieces_einsum(eq, a, b):
    """A product as K4's f32 kernels run it on the CPU: the six products of
    the operands' three bf16 pieces (``three_pieces``) whose indices sum to
    at most 2, smallest first, each a product of bf16 values (exact in f32)
    summed in f32."""
    pa, pb = fk.three_pieces(a), fk.three_pieces(b)
    out = None
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        term = torch.einsum(eq, pa[i], pb[j])
        out = term if out is None else out + term
    return out


def f32_pieces_forward(q, k, v, *, causal, window, stats=False):
    """K4's f32 forward in the kernel's arithmetic: S = (scale q) kᵀ and O =
    P v as ``pieces_einsum`` products, the softmax in f32 as the plain
    version's (masked scores at MASK_VALUE); with ``stats`` also (m, l)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    s = pieces_einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kvh, h // kvh, d) * d**-0.5, k)
    keep = fk._keep(sq, sk, causal, window, "cpu")
    if keep is not None:
        s = s.masked_fill(~keep, fk.MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = pieces_einsum("bkgqs,bskd->bqkgd", p, v) / torch.clamp(l.permute(0, 3, 1, 2, 4), min=1e-30)
    o = o.reshape(b, sq, h, d)
    return (o, m.reshape(b, h, sq), l.reshape(b, h, sq)) if stats else o


F32_TENTH = dict(rtol=2e-5, atol=2e-6)  # a tenth of K4's f32 tolerance
PIECE_SHAPES = [  # b, sq, sk, h, kvh, d, causal, window
    (1, 70, 70, 2, 1, 1, True, 0),        # D 1
    (2, 77, 77, 6, 3, 16, True, 9),       # a window
    (1, 130, 130, 4, 2, 64, True, 0),
    (1, 100, 100, 4, 1, 160, False, 0),   # stablelm-12b's D
    (1, 66, 66, 2, 1, 256, True, 20),     # recurrentgemma-9b's D and a window
    (1, 37, 130, 4, 2, 64, False, 0),     # cross, Sq < Sk
    (1, 1, 90, 8, 1, 128, False, 0),      # Sq 1
    (2, 40, 40, 4, 2, 8, True, 1),        # every row sees one key
    (1, 96, 64, 4, 2, 16, True, 20),      # rows 83.. see no key
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", PIECE_SHAPES,
                         ids=map(shape_id, PIECE_SHAPES))
def test_f32_pieces_forward_matches_jax_kernel(b, sq, sk, h, kvh, d, causal, window):
    # the f32 kernels' products (three bf16 pieces a side, six products)
    # stay within a tenth of the f32 tolerance of the Pallas kernel; a row
    # that sees no key (NaN there at these blocks) averages every key
    qn, kn, vn = inputs(b, sq, sk, h, kvh, d, seed=sq + sk + d)
    got = f32_pieces_forward(*map(torch.from_numpy, (qn, kn, vn)), causal=causal,
                             window=window).numpy()
    want = jops.flash_attention(*map(jnp.asarray, (qn, kn, vn)), causal=causal, window=window,
                                q_block=64, kv_block=64)
    keep = fk._keep(sq, sk, causal, window, "cpu")
    seen = np.ones(sq, bool) if keep is None else keep.any(1).numpy()
    np.testing.assert_allclose(got[:, seen], to_np(want)[:, seen], **F32_TENTH)
    mean = np.repeat(vn.mean(1), h // kvh, axis=1)[:, None].repeat((~seen).sum(), axis=1)
    np.testing.assert_allclose(got[:, ~seen], mean, **F32_TENTH)


def test_three_pieces_hold_every_bit_of_f32():
    """x0 + x1 + x2 == x in f32 for values of magnitude 2^-100 to 2^126 of
    either sign, and zeros stay zero.  The split has two limits outside
    that range: within a bf16 rounding of f32's largest value bf16(x)
    rounds to infinity, and below 2^-110 or so the last piece x2 (about
    2^-16 of x) falls among the subnormals and keeps fewer bits."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 100_000)
    x = np.ldexp(mant, rng.integers(-100, 127, mant.size)) * rng.choice([-1.0, 1.0], mant.size)
    x = torch.from_numpy(x.astype(np.float32))
    x0, x1, x2 = fk.three_pieces(x)
    for piece in (x0, x1, x2):
        assert torch.equal(piece, piece.bfloat16().float())  # each a bf16 value
    assert torch.equal((x0 + x1) + x2, x)
    assert torch.equal(x0 + (x1 + x2), x)
    zeros = fk.three_pieces(torch.zeros(5))
    assert all(torch.equal(z, torch.zeros(5)) for z in zeros)


@pytest.mark.parametrize("d,f32_products", [(64, 10), (5, 10), (128, 11), (256, 11)])
def test_f32_tensor_core_counts(d, f32_products):
    # the f32 forward's products run as six bf16 products each; the f32
    # backward forms 10 f32 products a tile pair up to D 64 (its dK/dV
    # kernel walks its rows once) and 11 past it (twice)
    args = (2, 2048, 2048, 32, d)
    assert ops.F32_PIECE_PRODUCTS == 6
    assert ops.tensor_core_flops(ops.kernel_flops(*args), bf16=False) == \
        6 * ops.kernel_flops(*args)
    assert ops.tensor_core_flops(ops.kernel_flops(*args), bf16=True) == ops.kernel_flops(*args)
    for causal in (True, False):
        assert ops.backward_flops(*args, causal=causal) == \
            f32_products / 2 * ops.kernel_flops(*args, causal=causal)
    assert ops.backward_flops(*args, bf16=True) == \
        (13 if d <= 128 else 12) / 2 * ops.kernel_flops(*args)


def test_wrapper_rejects_an_empty_head_dim():
    q = torch.zeros(1, 8, 2, 0)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention(q, q, q)


WALKS = [  # sq, sk, h, kvh, d, bf16, causal, window
    (300, 300, 4, 2, 64, True, True, 64),
    (2100, 2100, 16, 1, 256, True, True, 2048),   # recurrentgemma-9b past its window
    (4096, 4096, 16, 1, 256, False, True, 2048),
    (1200, 700, 16, 2, 256, True, True, 300),     # rows past every key
    (900, 500, 8, 2, 64, True, True, 200),
    (500, 100, 4, 4, 32, False, False, 30),       # a window without causality, rows past it
    (700, 1200, 8, 1, 160, True, False, 250),
    (77, 77, 6, 3, 16, False, True, 9),
    (130, 130, 4, 2, 200, True, True, 0),         # no window: from tile 0
    (1, 300, 8, 1, 136, True, False, 40),         # Sq 1
    (2048, 2048, 32, 8, 160, True, True, 0),
]


@pytest.mark.parametrize("sq,sk,h,kvh,d,bf16,causal,window", WALKS)
def test_forward_walk_covers_every_kept_pair(sq, sk, h, kvh, d, bf16, causal, window):
    # each forward CTA's walk over the key tiles (forward_walk, the kernels'
    # arithmetic): every pair its rows keep lies in a walked tile; a window
    # starts at the first row's window edge, where the first kept key is;
    # a CTA holding a row that sees no key walks every key tile from 0
    g, tile = h // kvh, fk.KEY_TILE
    rows, cta = sq * g, fk.forward_cta_rows(d, bf16)
    assert cta == (128 if bf16 and d > 128 else 64)
    keep = fk._keep(sq, sk, causal, window, "cpu")
    keep = torch.ones((sq, sk), dtype=torch.bool) if keep is None else keep
    for rho0 in range(0, rows, cta):
        first, last = rho0 // g, (min(rho0 + cta, rows) - 1) // g
        t_lo, t_end = fk.forward_walk(first, last, sk, causal, window)
        kept = keep[first:last + 1].nonzero()[:, 1]
        if kept.numel():
            assert int(kept.min()) // tile >= t_lo and int(kept.max()) // tile < t_end
        if not keep[first:last + 1].any(1).all():
            assert (t_lo, t_end) == (0, -(-sk // tile))
        else:
            assert t_lo == (max(0, first - window + 1) // tile if window else 0)
            assert t_lo == int(kept.min()) // tile
            if causal:
                assert t_end == min(-(-sk // tile), last // tile + 1)

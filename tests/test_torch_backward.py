"""The backward kernels' plain versions (K4's and K5's) on the CPU.

``flash_attention_backward_plain`` and ``ssd_scan_backward_plain`` are the
explicit forms of the gradients that ``csrc/flash_attention_bwd.cu`` and
``csrc/ssd_scan.cu``'s backward kernels evaluate; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to them on the card.  Here
each is held, on the same numpy-seeded inputs, to autograd of the port's
plain forward and to ``jax.grad`` of the JAX package's own functions
(``mha_ref`` for K4, the model's ``_ssd_chunked`` for K5; the JAX package
has no backward kernel): K4 f32 at rtol 2e-4 / atol 2e-5, bf16 inputs at
rtol 2e-2 with an atol of 2e-2 of each (row, head) RMS of the expected
gradient, K5 at 2e-4.  The tile walks of K4's backward kernels are
emulated too: every (query, key) pair that adds to a gradient lies in a
tile pair that the kernels visit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch import costs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssk  # noqa: E402
from test_torch_flash_attention import pieces_einsum  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-5)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def assert_rows_close(got, want, rtol=2e-2, rel_atol=2e-2):
    """bf16's tolerance: rtol, with an atol of ``rel_atol`` × the RMS of each
    expected row (the last dim)."""
    got, want = got.float(), want.float()
    atol = rel_atol * want.pow(2).mean(-1, keepdim=True).sqrt()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bool(bad.any()), f"{int(bad.sum())} elements beyond the bf16 row tolerance"


# -- K4 -----------------------------------------------------------------------
K4_CASES = [  # b, sq, sk, h, kvh, d, causal, window
    (2, 40, 40, 4, 2, 16, True, 0),       # causal
    (1, 70, 70, 4, 1, 8, True, 9),        # windowed, MQA
    (2, 23, 37, 6, 3, 12, False, 0),      # non-causal, Sq != Sk, G 2
    (2, 1, 50, 8, 1, 16, False, 0),       # a decode step: Sq 1, G 8
    (1, 33, 33, 2, 2, 1, True, 0),        # D 1, G 1
    (1, 20, 20, 4, 2, 160, True, 0),      # D 160
    (1, 30, 30, 16, 2, 8, True, 0),       # G 8
    (1, 50, 30, 4, 2, 8, False, 7),       # non-causal window past every key: masked rows
]
# causal with a window and Sq > Sk + window - 1: rows 33.. see no key
MASKED_ROWS = (2, 40, 28, 4, 2, 8, True, 6)


def k4_inputs(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [normal(rng, *s) for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                                      (b, sq, h, d))]


def plain_backward(q, k, v, gy, mask):
    o, m, l = fk.flash_attention_plain(q, k, v, stats=True, **mask)
    return fk.flash_attention_backward_plain(q, k, v, m, l, gy, **mask)


def autograd_of_plain(q, k, v, gy, mask):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fk.flash_attention_plain(*leaves, **mask)
    return torch.autograd.grad(out, leaves, gy)


def jax_grads(qn, kn, vn, gn, mask):
    def loss(q, k, v):
        return jnp.sum(jax_mha_ref(q, k, v, **mask).astype(jnp.float32) * gn)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", K4_CASES)
def test_k4_plain_backward_matches_autograd_and_jax(b, sq, sk, h, kvh, d, causal, window):
    qn, kn, vn, gn = k4_inputs(b, sq, sk, h, kvh, d, seed=sq + d)
    q, k, v, gy = map(torch.from_numpy, (qn, kn, vn, gn))
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    got = plain_backward(q, k, v, gy, mask)
    want = autograd_of_plain(q, k, v, gy, mask)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, w, **F32_TOL, msg=name)
    if window and sq > sk + window - 1:
        return  # mha_ref's -inf gives a fully masked row NaN; the next test holds it
    for name, g, w in zip("qkv", got, jax_grads(qn, kn, vn, gn, mask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL, err_msg=name)


def test_k4_fully_masked_rows_take_the_statistics_as_the_forward():
    """A row that sees no key: m = MASK_VALUE and l = Sk, where m + log l
    rounds back to m in f32; its P is 1 / Sk on every key (its output the
    mean of V), which reaches dV and nothing else, as autograd of the
    masked plain forward gives."""
    b, sq, sk, h, kvh, d, causal, window = MASKED_ROWS
    qn, kn, vn, gn = k4_inputs(b, sq, sk, h, kvh, d, seed=3)
    q, k, v, gy = map(torch.from_numpy, (qn, kn, vn, gn))
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    o, m, l = fk.flash_attention_plain(q, k, v, stats=True, **mask)
    masked = slice(sk + window - 1, sq)
    assert bool((m[:, :, masked] == fk.MASK_VALUE).all()) and bool((l[:, :, masked] == sk).all())
    lse = m[:, :, masked] + torch.log(l[:, :, masked])    # a single logsumexp would lose l
    assert bool((lse == m[:, :, masked]).all())
    torch.testing.assert_close(o[:, masked].float(),
                               v.repeat_interleave(h // kvh, dim=2).mean(1, keepdim=True)
                               .expand_as(o[:, masked]), rtol=1e-5, atol=1e-6)
    dq, dk, dv = fk.flash_attention_backward_plain(q, k, v, m, l, gy, **mask)
    assert bool((dq[:, masked] == 0).all())
    want = autograd_of_plain(q, k, v, gy, mask)
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        torch.testing.assert_close(g, w, **F32_TOL, msg=name)
    # only the masked rows' dO: dV is their uniform share, dK nothing
    gm = torch.zeros_like(gy)
    gm[:, masked] = gy[:, masked]
    _, dk_m, dv_m = fk.flash_attention_backward_plain(q, k, v, m, l, gm, **mask)
    assert bool((dk_m == 0).all())
    share = gm.reshape(b, sq, kvh, h // kvh, d).sum((1, 3)) / sk
    torch.testing.assert_close(dv_m, share[:, None].expand_as(dv_m), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", [
    (2, 40, 40, 4, 2, 16, True, 0),
    (1, 70, 70, 4, 1, 8, True, 9),
    (2, 23, 37, 6, 3, 12, False, 0),
    (1, 20, 20, 4, 2, 160, True, 0),
])
def test_k4_plain_backward_bf16_inputs(b, sq, sk, h, kvh, d, causal, window):
    """bf16 inputs: gradients in bf16 within the row tolerance of autograd
    of the plain forward and of ``jax.grad`` of ``mha_ref`` in f32 on the
    same rounded inputs."""
    qn, kn, vn, gn = k4_inputs(b, sq, sk, h, kvh, d, seed=sq + 1)
    q, k, v, gy = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn, gn))
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    got = plain_backward(q, k, v, gy, mask)
    want = autograd_of_plain(q, k, v, gy, mask)
    jw = jax_grads(*(x.float().numpy() for x in (q, k, v, gy)), mask)
    for name, g, w, j in zip("qkv", got, want, jw):
        assert g.dtype == torch.bfloat16, name
        assert_rows_close(g, w)
        assert_rows_close(g, torch.from_numpy(np.array(j)))


def f32_pieces_backward(q, k, v, gy, *, causal, window, scale):
    """K4's f32 backward in its kernels' arithmetic on the CPU (the
    forward's m and l, L recomputed, Δ from P and dP, P a quotient), every
    product as ``pieces_einsum``: (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qs = q.reshape(b, sq, kvh, g, d) * scale
    s = pieces_einsum("bqkgd,bskd->bkgqs", qs, k)
    keep = fk._keep(sq, sk, causal, window, "cpu")
    if keep is not None:
        s = s.masked_fill(~keep, fk.MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    norm = torch.where(m == fk.MASK_VALUE, e.sum(-1, keepdim=True), e.sum(-1, keepdim=True))
    p = e / torch.clamp(norm, min=1e-30)
    do = gy.reshape(b, sq, kvh, g, d)
    dv = pieces_einsum("bkgqs,bqkgd->bskd", p, do)
    dp = pieces_einsum("bqkgd,bskd->bkgqs", do, v)
    pdp = p * dp if keep is None else (p * dp).masked_fill(~keep, 0.0)
    ds = p * (dp - pdp.sum(-1, keepdim=True))
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = pieces_einsum("bkgqs,bskd->bqkgd", ds, k) * scale
    dk = pieces_einsum("bkgqs,bqkgd->bskd", ds, qs)
    return dq.reshape(b, sq, h, d), dk, dv


def float64_grads(q, k, v, gy, mask):
    """Autograd of the plain function in float64 (masked scores at
    MASK_VALUE: a row that sees no key gives its uniform P to dV)."""
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     leaves[0].reshape(b, sq, kvh, h // kvh, d) * mask["scale"], leaves[1])
    keep = fk._keep(sq, sk, mask["causal"], mask["window"], "cpu")
    if keep is not None:
        s = s.masked_fill(~keep, fk.MASK_VALUE)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), leaves[2]).reshape(b, sq, h, d)
    return torch.autograd.grad(o, leaves, gy.double())


PIECE_CASES = [  # b, sq, sk, h, kvh, d, causal, window
    (1, 33, 33, 2, 2, 1, True, 0),        # D 1
    (2, 40, 40, 4, 2, 16, True, 9),       # a window
    (1, 70, 70, 4, 1, 64, True, 0),
    (1, 40, 40, 4, 2, 160, False, 0),     # stablelm-12b's D
    (1, 30, 30, 2, 1, 256, True, 8),      # recurrentgemma-9b's D and a window
    (2, 23, 37, 6, 3, 12, False, 0),      # cross, Sq < Sk
    (2, 1, 50, 8, 1, 16, False, 0),       # Sq 1
    (1, 30, 30, 4, 2, 8, True, 1),        # every row sees one key
    MASKED_ROWS,                          # rows that see no key
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", PIECE_CASES)
def test_k4_f32_pieces_backward_matches_jax_grad(b, sq, sk, h, kvh, d, causal, window):
    """The f32 backward kernels' products (three bf16 pieces a side, six
    products) within a tenth of the f32 tolerance of ``jax.grad`` of the
    JAX package's ``mha_ref`` (float64 autograd of the plain function where
    a row sees no key, which ``mha_ref``'s -inf gives NaN); a row that sees
    one key has dQ = 0 exactly."""
    qn, kn, vn, gn = k4_inputs(b, sq, sk, h, kvh, d, seed=sq + sk + d)
    q, k, v, gy = map(torch.from_numpy, (qn, kn, vn, gn))
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    got = f32_pieces_backward(q, k, v, gy, **mask)
    if window and sq > sk + window - 1:
        want = [w.float() for w in float64_grads(q, k, v, gy, mask)]
    else:
        want = [torch.from_numpy(np.array(w)) for w in jax_grads(qn, kn, vn, gn, mask)]
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6, msg=name)
    if causal and window == 1:
        assert bool((got[0] == 0).all())


def k4_backward_walks(sq, sk, g, causal, window, d, bf16=True, splits=1):
    """The (row tile, key tile) pairs K4's backward kernels visit, as
    ``csrc/flash_attention_bwd.cu`` computes them: the dK/dV kernel's row
    tiles (64 rows) per key tile, and the rows kernel's key tiles per CTA
    of ``cta`` rows (the walks for L, Δ and dQ share them); and each grid's
    tiles in launch order with the length of each walk.  The dK/dV kernels
    take 64 keys a CTA; the rows kernels' key tiles are 64 keys but in the
    f32 kernels (``csrc/flash_attention_f32_bwd.cu``), whose tiles of
    pieces hold 64 keys at DP 64, 32 at DP 128, 16 at DP 192 and 256.  The
    bf16 rows kernel at DP 192 runs two warpgroups of 64 rows a CTA (128
    rows) over the union of their key tiles; elsewhere a CTA holds 64 rows.
    With ``splits`` ranges (the dK/dV grid short of a wave: bf16 past D 128,
    f32 at every width), ``ranges`` maps each key tile to the row tiles of
    each contiguous range of its walk.  Returns (dkdv pairs, rows pairs (CTA,
    row key tile), (64, cta), (dK/dV key tile, rows kernel's key tile),
    launches)."""
    rows, kt = 64, 64
    rkt = 64 if bf16 else {64: 64, 128: 32, 192: 16, 256: 16}[fk.padded_width(d)]
    cta = 2 * rows if bf16 and fk.padded_width(d) == 192 else rows
    total = sq * g
    dkdv, dq = set(), set()
    dkdv_len, dq_len, ranges = {}, {}, {}
    for kb in range(-(-sk // kt)):
        k0 = kb * kt
        k_last = min(k0 + kt, sk) - 1
        lo = k0 if causal else 0
        hi = min(sq, k_last + window) if window else sq
        t_lo = lo * g // rows
        t_hi = (hi * g + rows - 1) // rows if hi > lo else t_lo
        fm = sk + window - 1 if window else sq
        f_lo = max(t_hi, fm * g // rows)
        f_hi = max(f_lo, (sq * g + rows - 1) // rows) if fm < sq else f_lo
        walk = list(range(t_lo, t_hi)) + list(range(f_lo, f_hi))
        dkdv |= {(t, kb) for t in walk}
        dkdv_len[kb] = n = len(walk)
        ranges[kb] = [walk[sp * n // splits:(sp + 1) * n // splits] for sp in range(splits)]
    n_row_tiles = -(-total // cta)
    for t in range(n_row_tiles):
        first, last = t * cta // g, (min(t * cta + cta, total) - 1) // g
        k_lo = max(0, first - window + 1) if window else 0
        k_hi = min(sk, last + 1) if causal else sk
        t_lo = k_lo // rkt
        t_hi = (k_hi + rkt - 1) // rkt if k_hi > k_lo else t_lo
        dq |= {(t, kb) for kb in range(t_lo, t_hi)}
        dq_len[t] = t_hi - t_lo

    # longest walks first: the o-th CTA launched takes tile o, or n - 1 - o
    def order(n, reverse):
        return [n - 1 - o if reverse else o for o in range(n)]

    launches = {"dkdv": [(kb, dkdv_len[kb]) for kb in order(len(dkdv_len),
                                                           not causal and bool(window))],
                "rows": [(t, dq_len[t]) for t in order(n_row_tiles, causal)],
                "ranges": ranges}
    return dkdv, dq, (rows, cta), (kt, rkt), launches


@pytest.mark.parametrize("sq,sk,g,causal,window,d", [
    (200, 200, 1, True, 0, 64), (200, 200, 8, True, 0, 64), (300, 300, 2, True, 70, 128),
    (130, 90, 4, True, 20, 256), (55, 300, 5, False, 0, 64), (1, 300, 8, False, 0, 192),
    (150, 100, 3, False, 30, 64), (90, 300, 2, True, 0, 160), (300, 300, 1, True, 1, 32),
])
@pytest.mark.parametrize("bf16", [True, False])
def test_k4_backward_tile_walks_cover_every_contribution(sq, sk, g, causal, window, d, bf16):
    """Every pair with P != 0 (dV) lies in a tile pair the dK/dV kernel walks,
    and every pair the masks keep (dS, hence dQ and dK) in one that both
    kernels walk; pairs outside add nothing."""
    dkdv, dq, (rows, cta), (kt, rkt), _ = k4_backward_walks(sq, sk, g, causal, window, d, bf16)
    assert cta == (128 if bf16 and 128 < d <= 192 else 64)
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    masked_row = ~keep.any(1)
    gives_p = keep | masked_row[:, None]          # a fully masked row: 1 / Sk everywhere
    for rho in range(sq * g):
        for key in np.flatnonzero(gives_p[rho // g]):
            assert (rho // rows, key // kt) in dkdv, (rho, key)
        for key in np.flatnonzero(keep[rho // g]):
            assert (rho // cta, key // rkt) in dq, (rho, key)


@pytest.mark.parametrize("sq,sk,g,causal,window,d", [
    (2048, 2048, 8, True, 0, 64),      # tinyllama's training rows
    (2048, 2048, 8, True, 0, 128),     # qwen3-moe's
    (300, 300, 2, True, 0, 64),
    (150, 100, 3, False, 30, 64),      # a window without causality: the other way round
    (55, 300, 5, False, 0, 64),        # no mask: every walk as long
    (300, 300, 1, True, 70, 128),
    (2048, 2048, 4, True, 0, 160),     # stablelm-12b's: 128-row CTAs at DP 192
    (300, 300, 3, True, 0, 192),
    (2048, 2048, 16, True, 0, 256),    # D 256: 64-row CTAs (the keys split between warpgroups)
])
def test_k4_backward_grids_launch_the_longest_walks_first(sq, sk, g, causal, window, d):
    """Each grid launches every tile once; the causal grids (and a window's
    dK/dV grid) launch their walks from the longest to the shortest, so the
    short walks fill the card's last wave."""
    _, _, (rows, cta), (kt, _), launches = k4_backward_walks(sq, sk, g, causal, window, d)
    assert sorted(t for t, _ in launches["dkdv"]) == list(range(-(-sk // kt)))
    assert sorted(t for t, _ in launches["rows"]) == list(range(-(-sq * g // cta)))
    grids = ("dkdv", "rows") if causal and not window else \
        ("dkdv",) if window and not causal else ()
    for grid in grids:
        lengths = [n for _, n in launches[grid]]
        assert lengths == sorted(lengths, reverse=True), grid
    if causal and not window:  # the first CTA launched walks every tile it can
        assert launches["dkdv"][0] == (0, -(-sq * g // rows))
        assert launches["rows"][0][1] == -(-sk // kt)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", [
    (1, 4096, 4096, 16, 1, 256, True, 2048),   # recurrentgemma's windowed rows
    (1, 1024, 1024, 16, 1, 256, True, 300),    # the card test's split case
    (1, 130, 130, 4, 1, 256, True, 33),
    (2, 120, 70, 4, 2, 256, True, 20),         # masked rows past every key
    (1, 300, 300, 4, 2, 192, False, 0),
    (1, 200, 150, 8, 2, 200, True, 0),
])
def test_k4_backward_split_walks_take_each_tile_pair_once(b, sq, sk, h, kvh, d, causal, window):
    """Where the bf16 dK/dV grid past D 128 is short of a wave, each key
    tile's walk is cut into contiguous ranges, one CTA each: every (row
    tile, key tile) pair of the walk lies in exactly one range, the ranges
    in the walk's order, and the CTAs then fill a wave (or every range
    holds one row tile)."""
    splits = fk.walk_splits(b, sq, sk, h, kvh, d, True, 132)
    assert splits > 1
    g = h // kvh
    dkdv, _, _, (kt, _), launches = k4_backward_walks(sq, sk, g, causal, window, d,
                                                      splits=splits)
    whole, _, _, _, unsplit = k4_backward_walks(sq, sk, g, causal, window, d)
    assert kt == 64 and dkdv == whole
    key_ctas = b * kvh * -(-sk // kt)
    assert key_ctas * splits >= 132 or splits == -(-sq * g // 64)
    for kb, ranges in launches["ranges"].items():
        walk = unsplit["ranges"][kb][0]
        assert len(ranges) == splits
        assert [t for r in ranges for t in r] == walk  # in order, each tile once
        assert {(t, kb) for t in walk} == {p for p in dkdv if p[1] == kb}


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,bf16,want", [
    (1, 4096, 4096, 16, 1, 256, True, 3),      # recurrentgemma: 64 CTAs, 3 ranges fill a wave
    (1, 2048, 2048, 16, 1, 256, True, 5),      # 32 key tiles
    (1, 2048, 2048, 32, 8, 160, True, 1),      # stablelm-12b: 256 CTAs, unsplit
    (4, 2048, 2048, 32, 4, 64, True, 1),       # D 64: the one-warpgroup kernel, never split
    (1, 4096, 4096, 16, 1, 128, True, 1),      # D 128: likewise, short or not
    (1, 4096, 4096, 16, 1, 256, False, 3),     # f32: one CTA an SM too, split at every width
    (1, 4096, 4096, 16, 1, 64, False, 3),
    (1, 130, 130, 4, 1, 256, True, 9),         # at most the row tiles of a kv head
    (2, 4224, 4224, 8, 2, 192, True, 1),       # 2 x 2 x 66 = 264 CTAs: past a wave
    (1, 4224, 4224, 8, 2, 136, True, 1),       # 2 x 66 = 132 CTAs: exactly a wave
])
def test_k4_backward_split_engages_only_under_a_wave(b, sq, sk, h, kvh, d, bf16, want):
    assert fk.walk_splits(b, sq, sk, h, kvh, d, bf16, 132) == want


def test_k4_function_on_the_cpu_launches_nothing():
    qn, kn, vn, gn = k4_inputs(1, 20, 20, 4, 2, 8)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    before = (fk.flash_attention.launches, fk.flash_attention.backward_launches)
    out = fk.flash_attention(q, k, v)
    out.backward(torch.from_numpy(gn))
    assert (fk.flash_attention.launches, fk.flash_attention.backward_launches) == before
    with pytest.raises(ValueError):
        fk.flash_attention_backward(q.detach(), k.detach(), v.detach(), None,
                                    torch.from_numpy(gn), causal=True, window=0, scale=1.0)


class _Report:
    scale = 1

    def __init__(self):
        self.kernels = {}

    def charge_kernel(self, name, flops, hbm_bytes):
        self.kernels[name] = (flops, hbm_bytes)


@pytest.mark.parametrize("dtype,d", [
    pytest.param(torch.float32, 64, id="dtype0"), pytest.param(torch.bfloat16, 64, id="dtype1"),
    pytest.param(torch.bfloat16, 160, id="bf16-d160"),
    pytest.param(torch.bfloat16, 256, id="bf16-d256"),
])
def test_k4_meta_backward_charges_its_kernels(dtype, d):
    b, sq, h, kvh, window = 2, 96, 8, 2, 40
    q, k, v = (torch.empty(s, device="meta", dtype=dtype).requires_grad_()
               for s in ((b, sq, h, d), (b, sq, kvh, d), (b, sq, kvh, d)))
    with costs.pricing(_Report()) as report:
        out = fk.flash_attention(q, k, v, causal=True, window=window)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    el = 2 if dtype == torch.bfloat16 else 4
    share = fops.window_share(sq, sq, True, window)
    # bf16 at D 64: the wgmma kernels' 13 tile products and 8 planes of row
    # statistics; past D 128 12 products (P and dS without their remainders,
    # both warpgroups of the dK/dV kernel forming S and dP), and this grid
    # of 2 x 2 x 2 key tiles, short of a wave, walks its key tiles in 6
    # ranges (the row tiles of a kv head) whose f32 sums at DP 192 / 256 are
    # written and read once; f32 at D 64: 10 products, 6 planes and 6 ranges
    bf16 = dtype == torch.bfloat16
    planes = 8 if bf16 else 6
    products = (12 if d > 128 else 13) if bf16 else 10
    splits = fk.walk_splits(b, sq, sq, h, kvh, d, bf16, 132)
    assert splits == (1 if bf16 and d <= 128 else 6)
    part = 2 * splits * 2 * b * sq * kvh * fk.padded_width(d) * 4 if splits > 1 else 0
    io = 2 * (2 * b * sq * h * d + 2 * b * sq * kvh * d) * el
    assert fops.backward_hbm_bytes(b, sq, sq, h, kvh, d, bytes_per_el=el) == \
        io + planes * 4 * b * h * sq + part
    assert fops.backward_hbm_bytes(b, sq, sq, h, kvh, d, bytes_per_el=el, scratch=False) == \
        io + 2 * 4 * b * h * sq
    assert report.kernels["flash_attention_backward"] == (
        products / 2 * fops.kernel_flops(b, sq, sq, h, d) * share,
        fops.backward_hbm_bytes(b, sq, sq, h, kvh, d, bytes_per_el=el))
    assert report.kernels["flash_attention"][0] == fops.kernel_flops(b, sq, sq, h, d) * share


# -- K5 -----------------------------------------------------------------------
def ssd_inputs(b, s, h, p, n, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    x = normal(rng, b, s, h, p)
    log_a = (-0.2 * rng.random((b, s, h))).astype(np.float32)   # moderate: jax's grad is finite
    bm, cm = normal(rng, b, s, n, scale=0.3), normal(rng, b, s, n, scale=0.3)
    h0 = normal(rng, b, h, p, n, scale=0.5) if with_h0 else None
    gy, gh = normal(rng, b, s, h, p), normal(rng, b, h, p, n)
    return x, log_a, bm, cm, h0, gy, gh


def ssd_autograd_of_plain(args, h0, gy, gh, chunk):
    leaves = [t.clone().requires_grad_() for t in args]
    h0l = None if h0 is None else h0.clone().requires_grad_()
    y, hf = ssk.ssd_scan_plain(*leaves, chunk=chunk, h0=h0l)
    pairs = [(o, g) for o, g in ((y, gy), (hf, gh)) if g is not None]
    wrt = leaves + ([h0l] if h0l is not None else [])
    grads = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                allow_unused=True)
    return list(grads[:4]) + [grads[4] if h0l is not None else None]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 100, 3, 8, 16, 32),        # a partial last sub-chunk
    (1, 64, 2, 16, 8, 16),         # exactly one sub-chunk
    (1, 150, 2, 80, 12, 64),       # P > 64: two P tiles in the kernels
    (2, 130, 1, 4, 70, 256),       # N past one slab of 64, a chunk past the length
])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("through", ["y", "state", "both"])
def test_k5_plain_backward_matches_autograd_and_jax(b, s, h, p, n, chunk, with_h0, through):
    xn, lan, bn, cn, h0n, gyn, ghn = ssd_inputs(b, s, h, p, n, seed=s + p, with_h0=with_h0)
    gyn = gyn if through != "state" else None
    ghn = ghn if through != "y" else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    args, h0, gy, gh = [t(a) for a in (xn, lan, bn, cn)], t(h0n), t(gyn), t(ghn)
    got = ssk.ssd_scan_backward_plain(*args, h0, gy, gh)
    want = ssd_autograd_of_plain(args, h0, gy, gh, chunk)
    names = ("x", "log_a", "B", "C", "h0")
    for name, g, w in zip(names, got, want):
        if name == "h0" and not with_h0:
            assert g is None
            continue
        if name == "C" and through == "state":  # C reaches y only
            assert w is None
            assert bool((g == 0).all())
            continue
        torch.testing.assert_close(g, w, **SSD_TOL, msg=name)

    def loss(x, la, bm, cm, h0):
        y, hf = _ssd_chunked(x, la, bm, cm, chunk, h0)
        total = jnp.sum(y * gyn) if gyn is not None else 0.0
        return total + (jnp.sum(hf * ghn) if ghn is not None else 0.0)

    jargs = [jnp.asarray(a) for a in (xn, lan, bn, cn)] + [
        jnp.asarray(h0n) if with_h0 else jnp.zeros((b, h, p, n), jnp.float32)]
    jw = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    for name, g, w in zip(names, got, jw):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **SSD_TOL, err_msg=name)


def test_k5_function_on_the_cpu_launches_nothing():
    xn, lan, bn, cn, _, gyn, ghn = ssd_inputs(1, 70, 2, 4, 8)
    args = [torch.from_numpy(a).requires_grad_() for a in (xn, lan, bn, cn)]
    before = (ssk.ssd_scan.launches, ssk.ssd_scan.backward_launches)
    y, hf = ssk.ssd_scan(*args, chunk=32)
    torch.autograd.grad((y, hf), args, (torch.from_numpy(gyn), torch.from_numpy(ghn)))
    assert (ssk.ssd_scan.launches, ssk.ssd_scan.backward_launches) == before
    with pytest.raises(ValueError):
        ssk.ssd_scan_backward(*(a.detach() for a in args), None, torch.from_numpy(gyn), None)


@pytest.mark.parametrize("with_h0", [False, True])
def test_k5_meta_backward_charges_its_kernels(with_h0):
    b, s, h, p, n = 2, 300, 4, 64, 32
    args = [torch.empty(sh, device="meta").requires_grad_()
            for sh in ((b, s, h, p), (b, s, h), (b, s, n), (b, s, n))]
    h0 = torch.empty((b, h, p, n), device="meta").requires_grad_() if with_h0 else None
    with costs.pricing(_Report()) as report:
        y, _ = ssk.ssd_scan(*args, chunk=64, h0=h0)
        wrt = args + ([h0] if with_h0 else [])
        grads = torch.autograd.grad(y, wrt, torch.empty_like(y))
    assert [g.shape for g in grads] == [t.shape for t in wrt]
    assert report.kernels["ssd_scan_backward"] == (
        sops.backward_flops(b, s, h, p, n), sops.backward_hbm_bytes(b, s, h, p, n,
                                                                    with_h0=with_h0))
    # per sub-chunk and head: the states twice (2QPN + 2PN each), dy·xᵀ and
    # (G ⊙ L)ᵀ·dy, B·dh_outᵀ and C·h_inᵀ, dy·xᵀ again for each 64 columns
    # of N, M·B and Mᵀ·C, dy·h_in and x·dh_out; C·Bᵀ once a sub-chunk
    q, n_sub = ssk.SUB, -(-s // ssk.SUB)
    per_head = (2 * (2 * q * p * n + 2 * p * n) + 2 * 2 * q * q * p + 4 * 2 * q * p * n
                + 1 * 2 * q * q * p + 2 * 2 * q * q * n)
    assert sops.backward_flops(b, s, h, p, n) == b * n_sub * (h * per_head + 2 * q * q * n)


def test_k5_backward_scratch_holds_no_heads_shares_of_dB_and_dC():
    """At mamba2-130m's training microbatch (B 4 × 2048, H 24, P 64, N 128)
    on an H100 (132 SMs) the dB and dC kernel walks every head in one group,
    and the backward's scratch is the recomputed states and their gradients
    (B, S/64, H, P, N) and what is per sub-chunk and head at most 64
    floats, or per sub-chunk 64 × 64: nothing holds the heads' shares of dB
    and dC (B, S/64, H, 64, N) as PR 23's 201 MB ``part_bc`` did.  A grid
    under one wave (B 1 × 1000) splits the heads into groups whose sums
    (groups × B × S × N, groups < H) are the only added scratch."""
    b, s, h, p, n = 4, 2048, 24, 64, 128
    groups = ssk.head_groups(b, s, h, n, 132)
    assert groups == 1
    scratch = ssk.backward_scratch(b, s, h, p, n, "meta", groups)
    assert scratch.pop("part_groups") is None
    n_sub = s // ssk.SUB
    states = b * n_sub * h * p * n
    assert [tuple(t.shape) for t in scratch.values()] == [
        (b, n_sub, h, p, n), (b, n_sub, h, p, n), (b, n_sub, h), (b, n_sub, 64, 64),
        (b, h, p, n), (b, n_sub, h, 1, 64)]
    assert all(t.dtype == torch.float32 for t in scratch.values())
    rest = {k: t.numel() for k, t in scratch.items() if k not in ("states", "dstates")}
    heads_shares = b * n_sub * h * ssk.SUB * n          # one of dB's or dC's share planes
    assert sum(rest.values()) < heads_shares / 4, rest
    for name, numel in rest.items():                    # per sub-chunk: no H × N term
        per_sub = numel / (b * n_sub) if name != "h_last" else 0
        assert per_sub <= max(h * 64, 64 * 64), name
    total_mb = sum(t.numel() for t in scratch.values()) * 4 / 1e6
    assert total_mb < 2 * states * 4 / 1e6 + 10, total_mb
    # 16 sub-chunks x 2 column blocks = 32 CTAs: 4 groups of 6 heads fill 128 of 132 SMs
    assert ssk.head_groups(1, 1000, h, n, 132) == 4
    part = ssk.backward_scratch(1, 1000, h, p, n, "meta", 4)["part_groups"]
    assert tuple(part.shape) == (4, 2, 1, 1000, n)
    assert ssk.head_groups(1, 1, h, n, 132) == h  # never more groups than heads

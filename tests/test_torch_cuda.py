"""The port's CUDA kernels, CUDA stream units and model path, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the reference package, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

K1 and K2 evaluate the plain oracle's operations in its order and K3 sums
in its plain version's order, so each kernel is held to its plain version
bitwise; the kernels' outputs are also held against the oracles at the
reference's tolerances.  K3 adds only the nonzero entries of a block, in
its plain version's order, so it is held to it bitwise as well.  K4 and
K5 sum in other orders than their plain versions and are held to them at
the reference tests' tolerances (f32 2e-4, bf16 2e-2); K4's bf16 path
runs on the tensor cores, and one tile of each of its two products is
also held against a plain matrix product.  A worker process
(``spawn_worker``) hosting ``cuda`` units runs K3 bitwise equal to a launch
here, and a remote prefill equals the inline one.  K4 is also held in the
forms the hybrid, encdec and vlm families call it in (no mask at Sq ≠ Sk,
Sq 1, a window that masks), and those families' smoke models give the same
greedy tokens through K4 as through its plain version.  K4's and K5's
``Function``s carry gradients: an output requires grad when an input
does, the gradients match autograd of the plain versions, and a smoke
train step through the kernels matches one through the plain versions.
The backward kernels (K4's and K5's) are held to their plain versions in
both of K4's dtypes and at the training shapes, give the same bits on two
calls, and count in ``backward_launches`` apart from the forwards.
K4's bf16 forward past D 128 (``flash_fwd_bf16_wide``) is held to the
plain version in every form its walk meets (windows, rows that see no key,
Sq 1, Sq ≠ Sk), gives the same bits on two calls, and writes the plain
version's row statistics.
What a model axis of 2 hands the kernels is held too: K4 on a rank's
heads equals those heads of the full call, and the loss's vocab-parallel
cross-entropy on two halves of the vocabulary equals the plain loss.
"""

import ctypes
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import _build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_eneac import HotspotConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CompletionBus, CudaStreamUnit, HeteroRuntime, RemoteUnit, WorkerKind, spawn_worker,
)
from repro_torch.core.parallel_for import SplitDecision  # noqa: E402
from repro_torch.core.scheduler import Chunk  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.kernels.hotspot import hotspot as hk  # noqa: E402
from repro_torch.kernels.hotspot import ops as hops  # noqa: E402
from repro_torch.kernels.hotspot import ref as href  # noqa: E402
from repro_torch.kernels.launches import LaunchCounts  # noqa: E402
from repro_torch.kernels.spmm import ops as sops  # noqa: E402
from repro_torch.kernels.spmm import ref as sref  # noqa: E402
from repro_torch.kernels.spmm import spmm as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssk  # noqa: E402
from repro_torch.models import make_model, transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

HOTSPOT_TOL = dict(rtol=1e-5, atol=1e-4)
SPMM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def grids(n, device, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    shape = (n, n if cols is None else cols)
    return (torch.from_numpy(80.0 + 10.0 * rng.random(shape, np.float32)).to(device),
            torch.from_numpy(rng.random(shape, np.float32)).to(device))


@pytest.mark.parametrize("rows,cols,steps", [
    (64, 64, 1), (256, 256, 8),
    # the paper's grid: the one-step kernel (1), one phase (2, 7, 8 steps),
    # and two or three phases of equal depth (9: 5 + 4; 17: 6 + 6 + 5)
    (2048, 2048, 1), (2048, 2048, 2), (2048, 2048, 7), (2048, 2048, 8), (2048, 2048, 9),
    (2048, 2048, 17),
    # ragged tiles, and grids where every halo touches an edge; 257 x 1000
    # at every depth of the tiled phases, 2 to 8 (9: 5; 17: 6; 24: 8 + 8 + 8)
    (257, 1000, 1), (257, 1000, 2), (257, 1000, 3), (257, 1000, 4), (257, 1000, 6),
    (257, 1000, 7), (257, 1000, 9), (257, 1000, 17), (257, 1000, 24),
    (1, 5, 1), (1, 5, 9), (3, 3, 1), (3, 3, 9),
])
def test_k1_matches_plain(cuda, rows, cols, steps):
    t, p = grids(rows, cuda, cols=cols)
    cfg = HotspotConfig(grid=max(rows, cols))
    n = hk.hotspot_hpc.launches
    got = hk.hotspot_hpc(t, p, cfg, steps)
    assert hk.hotspot_hpc.launches == n + 1
    assert torch.equal(got, hk.hotspot_hpc_plain(t, p, cfg, steps))
    torch.testing.assert_close(got, href.hotspot_ref(t, p, cfg, steps), **HOTSPOT_TOL)


@pytest.mark.parametrize("steps", [1, 6])
@pytest.mark.parametrize("fill", ["ambient", "ambient_then_random"])
def test_k1_zero_numerators_match_plain(cuda, fill, steps):
    # a uniform grid at the ambient temperature zeroes all three numerators
    # of the stencil, which K1's fast division leaves to step_math (in the
    # one-step kernel and in the tiled one)
    cfg = HotspotConfig(grid=300)
    t, p = grids(300, cuda, seed=4)
    t = torch.full_like(t, cfg.amb_temp)
    if fill == "ambient_then_random":
        t[100:200, 50:250] = 80.0 + 10.0 * torch.rand(100, 200, device=cuda,
                                                      generator=torch.Generator(cuda).manual_seed(0))
    got = hk.hotspot_hpc(t, p, cfg, steps)
    assert torch.equal(got, hk.hotspot_hpc_plain(t, p, cfg, steps))


@pytest.mark.parametrize("grid,lo,hi", [(256, 63, 130), (2048, 127, 257)])
def test_k1_band_with_full_grid_coefficients(cuda, grid, lo, hi):
    # the runtime's ACC chunk: 128 rows and a halo row each side, steps=1
    t, p = grids(grid, cuda)
    cfg = HotspotConfig(grid=grid)
    band, pband = t[lo:hi].contiguous(), p[lo:hi].contiguous()
    got = hk.hotspot_hpc(band, pband, cfg, 1, grid=(grid, grid))
    assert torch.equal(got, hk.hotspot_hpc_plain(band, pband, cfg, 1, grid=(grid, grid)))
    assert torch.equal(got[1:-1], href.hotspot_step_ref(t, p, cfg)[lo + 1:hi - 1])


def test_k1_refuses_2_to_the_31_cells(cuda):
    big = torch.empty((2 ** 16, 2 ** 15), device=cuda)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        hk.hotspot_hpc(big, big, HotspotConfig(), 1)


@pytest.mark.parametrize("grid", [64, 2048])
def test_k2_matches_plain(cuda, grid):
    t, p = grids(grid, cuda)
    cfg = HotspotConfig(grid=grid)
    n = hk.hotspot_hp_step.launches
    got = hk.hotspot_hp_step(t, p, cfg)
    assert hk.hotspot_hp_step.launches == n + 1
    want = hk.hotspot_hp_step_plain(t, hk.shift_rows(t, "up"), hk.shift_rows(t, "down"), p, cfg)
    assert torch.equal(got, want)


def test_hetero_hotspot_equals_oracle(cuda):
    R = 256
    cfg = HotspotConfig(grid=R, iterations=R)
    t, p = grids(R, cuda, seed=2)
    for port in ("hp", "hpc"):
        run = hops.hotspot_hetero(t, p, cfg, 4, port=port, acc_chunk=32)
        assert all(rep.items == R for rep in run.reports)
        assert torch.equal(run.out, href.hotspot_ref(t, p, cfg, 4))


@pytest.mark.parametrize("rows,cols,n,nnz_mean", [(40, 256, 16, 2.0), (1000, 3000, 100, 120.0)])
def test_k3_matches_plain(cuda, rows, cols, n, nnz_mean):
    p = sref.make_problem(rows, cols, n, nnz_mean=nnz_mean, seed=rows)
    arrays = sk.BlockEllArrays(sref.to_block_ell(p), cuda)
    rhs = torch.from_numpy(sops.pad_rhs(p)).to(cuda)
    before = sk.spmm_block_ell.launches
    got = sk.spmm_block_ell(arrays, rhs)
    assert sk.spmm_block_ell.launches == before + 1
    assert torch.equal(got, sk.spmm_block_ell_plain(arrays, rhs))
    np.testing.assert_allclose(got[:rows, :n].cpu().numpy(), sref.spmm_dense_ref(p), **SPMM_TOL)


def block_ell_edge_cases(k_max, n_cb, seed=0):
    """Row blocks at the kernel's edges: rb 0 is full (count = K) with
    nonzeros only at columns 0 and 127 and one occupied block of zeros;
    rb 1 holds a dense block, a block of -0.0 and a sparse one; rb 2 is
    empty; rb 3 is 1 % dense over K/2 blocks.  K > 24 wraps the kernel's
    ring of three 8-block stages."""
    rng = np.random.default_rng(seed)
    counts = np.array([k_max, 3, 0, k_max // 2], np.int32)
    vals = np.zeros((4, k_max, 8, 128), np.float32)
    colblocks = np.zeros((4, k_max), np.int32)
    for rb, count in enumerate(counts):
        colblocks[rb, :count] = np.sort(rng.choice(n_cb, count, replace=False))
    vals[0, :, :, 0] = rng.standard_normal((k_max, 8))
    vals[0, :, :, 127] = rng.standard_normal((k_max, 8))
    vals[0, 1] = 0.0
    vals[1, 0] = rng.standard_normal((8, 128))
    vals[1, 1] = -0.0
    vals[1, 2, 3, ::17] = 1.0
    live = rng.random((k_max // 2, 8, 128)) < 0.01
    vals[3, :k_max // 2][live] = rng.standard_normal(int(live.sum()))
    return sref.BlockEll(vals=vals, colblocks=colblocks, counts=counts, rows=32,
                         n_cols=n_cb * 128)


@pytest.mark.parametrize("n", [16, 128, 256])
def test_k3_edge_blocks_equal_plain(cuda, n):
    be = block_ell_edge_cases(k_max=30, n_cb=40)
    arrays = sk.BlockEllArrays(be, cuda)
    rhs = torch.from_numpy(np.random.default_rng(1).standard_normal((40 * 128, n))
                           .astype(np.float32)).to(cuda)
    before = sk.spmm_block_ell.launches
    got = sk.spmm_block_ell(arrays, rhs)
    assert sk.spmm_block_ell.launches == before + 1
    assert torch.equal(got, sk.spmm_block_ell_plain(arrays, rhs))
    assert not got[16:24].any()  # the empty row block


def test_hybrid_executor_on_card(cuda):
    p = sref.make_problem(48, 256, 16, nnz_mean=6.0, seed=3)
    ex, order = sops.make_hybrid_executor(p, device=cuda)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    for nd in (0, 16, 48):
        res, _ = ex.run(SplitDecision(n_dense=nd, n_sparse=48 - nd, predicted_time=0.0))
        assert res.device.type == "cuda"
        np.testing.assert_allclose(res.cpu().numpy()[inv], sref.spmm_dense_ref(p), **SPMM_TOL)


def test_cuda_unit_runs_on_its_own_stream(cuda):
    unit = CudaStreamUnit("g0")
    bus = CompletionBus()
    streams = []

    def work(c):
        streams.append(torch.cuda.current_stream())
        return (torch.arange(c.size, device=cuda, dtype=torch.float32) * 2.0).sum()

    unit.start(bus)
    try:
        unit.submit(Chunk(0, 8, "g0"), work)
        assert bus.wait(timeout=30.0)
        rec = bus.drain()[0]
    finally:
        unit.close()
    assert rec.error is None and float(rec.result) == 56.0
    assert streams[0] == unit.stream != torch.cuda.default_stream(cuda)


def test_cuda_unit_counts_its_enqueue_as_dispatch(cuda):
    # as the reference's device unit: dispatch runs from the submit to the
    # end of the work function's call (the enqueue), elapsed from there to
    # the event
    unit = CudaStreamUnit("g0")
    bus = CompletionBus()

    def work(c):
        time.sleep(0.05)  # a slow host enqueue
        return torch.ones(c.size, device=cuda).sum()

    unit.start(bus)
    try:
        unit.submit(Chunk(0, 8, "g0"), work)
        assert bus.wait(timeout=30.0)
        rec = bus.drain()[0]
    finally:
        unit.close()
    assert rec.error is None and float(rec.result) == 8.0
    assert rec.dispatch_latency >= 0.05 > rec.elapsed


def test_cuda_units_cover_exactly_once(cuda):
    out = torch.zeros(4096, device=cuda)

    def work(c):
        out[c.start:c.stop] += 1.0

    rt = HeteroRuntime()
    for i in range(3):
        rt.register_unit(f"g{i}", WorkerKind.ACC, work_fn=work, backend=CudaStreamUnit(f"g{i}"))
    rt.register_unit("cc0", WorkerKind.CC, work_fn=work)
    rep = rt.parallel_for(num_items=4096, engine="interrupt", acc_chunk=128)
    assert rep.items == 4096
    assert torch.equal(out, torch.ones_like(out))


def attention_inputs(b, sq, sk, h, kvh, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
            for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d))]


@pytest.mark.parametrize("b,sq,h,kvh,d,causal,window", [
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 8, 1, 16, True, 0),
    (2, 128, 4, 4, 64, False, 0),
    (1, 256, 4, 2, 32, True, 64),
    (1, 128, 2, 2, 128, True, 0),
    (1, 1000, 32, 4, 64, True, 0),     # tinyllama's heads, ragged length
    (1, 77, 6, 3, 16, True, 9),        # ragged everything, odd group count
    (1, 891, 32, 4, 64, True, 0),      # tinyllama's longest served prompt
    (1, 500, 40, 8, 128, True, 0),     # qwen3-14b's heads: G = 5, D = 128
    # head dims between the padded widths: the smoke configs' 8, then 24, 80,
    # stablelm-12b's 160, 192 and recurrentgemma-9b's 256 (window 2048 there)
    (2, 77, 4, 2, 8, True, 0),
    (1, 130, 6, 3, 24, True, 0),
    (1, 200, 4, 2, 80, False, 0),
    (1, 891, 32, 8, 160, True, 0),
    (1, 150, 4, 1, 192, True, 33),
    (1, 300, 16, 1, 256, True, 2048),
    (1, 129, 4, 2, 256, False, 50),
    # D % 8 != 0: the bf16 path pads D to a multiple of 8 in the wrapper
    (1, 70, 2, 1, 1, True, 0),
    (2, 65, 4, 2, 5, True, 0),
    (1, 100, 4, 4, 100, False, 0),
    (1, 70, 2, 1, 250, True, 9),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, b, sq, h, kvh, d, causal, window, dtype):
    q, k, v = attention_inputs(b, sq, sq, h, kvh, d, dtype, cuda, seed=sq)
    n = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, causal=causal, window=window)
    assert fk.flash_attention.launches == n + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(got.float(), mha_ref(q, k, v, causal=causal, window=window).float(),
                               **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_takes_strided_and_unaligned_inputs(cuda, dtype):
    # a non-contiguous q, k, v (heads-major storage) is made contiguous by
    # the wrapper; contiguous views that start 2 bytes past a 16-byte
    # boundary are copied to aligned buffers for the bf16 path's copies
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    q, k, v = attention_inputs(1, 200, 200, 8, 2, 64, dtype, cuda, seed=11)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(fk.flash_attention(qt, kt, vt).float(),
                               fk.flash_attention_plain(q, k, v).float(), **tol)
    shifted = []
    for x in (q, k, v):
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        shifted.append(view)
    assert shifted[0].is_contiguous() and shifted[0].data_ptr() % 16 != 0
    n = fk.flash_attention.launches
    got = fk.flash_attention(*shifted)
    assert fk.flash_attention.launches == n + 1
    torch.testing.assert_close(got.float(), fk.flash_attention_plain(q, k, v).float(), **tol)


def test_k4_refuses_head_dims_past_256(cuda):
    q = torch.zeros(1, 64, 2, 257, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        fk.flash_attention(q, q, q)


def test_k4_cross_lengths(cuda):
    # Sq != Sk, non-causal and causal (top-left aligned), ragged both ways
    for sq, sk in ((37, 200), (130, 65)):
        q, k, v = attention_inputs(2, sq, sk, 4, 2, 64, torch.float32, cuda, seed=sk)
        for causal in (False, True):
            torch.testing.assert_close(
                fk.flash_attention(q, k, v, causal=causal),
                fk.flash_attention_plain(q, k, v, causal=causal), rtol=2e-4, atol=2e-5)


def test_k4_cross_lengths_bf16(cuda):
    # Sq != Sk on the tensor-core path, ragged both ways, against both references
    for sq, sk_len in ((37, 200), (130, 65), (200, 1000)):
        q, k, v = attention_inputs(2, sq, sk_len, 8, 2, 64, torch.bfloat16, cuda, seed=sk_len)
        for causal in (False, True):
            got = fk.flash_attention(q, k, v, causal=causal).float()
            for want in (fk.flash_attention_plain(q, k, v, causal=causal),
                         mha_ref(q, k, v, causal=causal)):
                torch.testing.assert_close(got, want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sq,sk,h,kvh,d,causal,window", [
    # cross-attention, no mask: whisper's decoder (20/20 heads, D 64) over
    # 1500 encoder frames at a decode step (Sq 1), a short and a long
    # prompt; the vision model's 891-token prompt over 1024 image tokens
    (1, 1500, 20, 20, 64, False, 0),
    (7, 1500, 20, 20, 64, False, 0),
    (448, 1500, 20, 20, 64, False, 0),
    (891, 1024, 64, 8, 128, False, 0),
    # recurrentgemma-9b's local attention past its window: 52 keys masked
    # for the last query
    (2100, 2100, 16, 1, 256, True, 2048),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_cross_and_windowed_forms(cuda, sq, sk, h, kvh, d, causal, window, dtype):
    q, k, v = attention_inputs(1, sq, sk, h, kvh, d, dtype, cuda, seed=sq + sk)
    n = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, causal=causal, window=window)
    assert fk.flash_attention.launches == n + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    for want in (fk.flash_attention_plain(q, k, v, causal=causal, window=window),
                 mha_ref(q, k, v, causal=causal, window=window)):
        want = want.float()
        # bf16: an atol of 2e-2 of the RMS of each (query, head) row, which
        # falls as 1/sqrt(keys attended); a fixed 2e-2 would pass a lost
        # key tile
        rtol, atol = ((2e-4, 2e-5) if dtype == torch.float32 else
                      (2e-2, 2e-2 * want.pow(2).mean(-1, keepdim=True).sqrt()))
        excess = (got.float() - want).abs() - (atol + rtol * want.abs())
        assert float(excess.max()) <= 0, f"beyond the tolerance by {float(excess.max())}"


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 160, 192, 256])
def test_k4_wgmma_tile_products(cuda, d):
    # one 64-row tile of each bf16 product in K4's shared-memory layouts:
    # S = q kᵀ (K-major operands) and O = bf16(S) v (P from registers, V
    # MN-major), against plain f32 products of the same bf16 values
    probe = _build.function("flash_attention", "flash_attention_wgmma_probe",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(64, d, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    s = torch.empty((64, 64), device=cuda)
    o = torch.empty((64, d), device=cuda)
    err = probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d,
                torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", err, "wgmma probe")
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(o, s.bfloat16().float() @ v.float(), rtol=1e-5, atol=1e-3)


# -- K4's bf16 forward past D 128: flash_fwd_bf16_wide ------------------------
WIDE_SHAPES = [  # b, sq, sk, h, kvh, d, causal, window
    (1, 300, 300, 4, 4, 136, True, 0),         # G 1, D padded to 160 columns
    (1, 891, 891, 32, 8, 160, True, 0),        # stablelm-12b's heads at the longest prompt
    (2, 200, 200, 16, 1, 192, True, 0),        # G 16
    (1, 150, 150, 4, 1, 200, False, 0),        # D padded to 256 columns
    (2, 129, 129, 4, 2, 192, False, 0),
    (1, 2100, 2100, 16, 1, 256, True, 2048),   # recurrentgemma-9b past its window
    (1, 333, 333, 16, 1, 200, True, 100),      # ragged, a window
    (1, 1, 700, 16, 1, 256, False, 0),         # Sq 1 (a decode step)
    (1, 1, 700, 4, 4, 160, True, 0),           # Sq 1, causal: key 0 alone
    (2, 77, 130, 8, 2, 160, False, 0),         # Sq < Sk, ragged both ways
    (1, 130, 65, 4, 1, 256, True, 0),          # Sq > Sk, causal (top-left)
    (1, 1200, 700, 16, 2, 256, True, 300),     # a window past every key of the last rows
    (1, 500, 200, 4, 4, 136, False, 50),       # the same without causality, G 1
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", WIDE_SHAPES)
def test_k4_wide_forward_matches_plain(cuda, b, sq, sk, h, kvh, d, causal, window):
    # bf16 past D 128 launches flash_fwd_bf16_wide (counted in both of K4's
    # counts); it is held to the plain version at phase 4's bf16 tolerance,
    # a row that sees no key averages every key as the plain version does,
    # two calls give the same bits, and with the statistics it writes the
    # same output and the plain version's m and l
    q, k, v = attention_inputs(b, sq, sk, h, kvh, d, torch.bfloat16, cuda, seed=sq + sk + d)
    mask = dict(causal=causal, window=window)
    n, nw = fk.flash_attention.launches, fk.flash_attention.wide_launches
    got = fk.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches, fk.flash_attention.wide_launches) == (n + 1, nw + 1)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert within_tol(got, fk.flash_attention_plain(q, k, v, **mask), torch.bfloat16)
    assert torch.equal(fk.flash_attention(q, k, v, **mask), got)
    out, stats = fk._launch(q, k, v, causal, window, d**-0.5, stats=True)
    assert torch.equal(out, got)
    _, m, l = fk.flash_attention_plain(q, k, v, stats=True, **mask)
    torch.testing.assert_close(stats[0], m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1], l, rtol=2e-4, atol=1e-5)


def test_k4_narrow_library_refuses_bf16_past_d128(cuda):
    # no fallback: the one-warpgroup library no longer takes bf16 past D 128
    launch = _build.function("flash_attention", "flash_attention_launch", fk._ARGS)
    q = torch.zeros(1, 64, 2, 160, device=cuda, dtype=torch.bfloat16)
    err = launch(q.data_ptr(), q.data_ptr(), q.data_ptr(), torch.empty_like(q).data_ptr(),
                 1, 64, 64, 2, 2, 160, 1, 0, 160**-0.5, None,
                 torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue


# -- K4's float32 kernels: three bf16 pieces an operand, on wgmma ---------------
F32_SHAPES = [  # b, sq, sk, h, kvh, d, causal, window
    (1, 70, 70, 2, 1, 1, True, 0),           # D 1
    (2, 130, 130, 4, 2, 16, True, 0),
    (1, 300, 300, 8, 2, 64, True, 0),
    (1, 200, 200, 4, 2, 128, True, 64),      # a window
    (1, 333, 333, 16, 2, 160, True, 0),      # stablelm-12b's D
    (2, 150, 150, 8, 1, 192, False, 0),
    (1, 400, 400, 16, 1, 256, True, 300),    # recurrentgemma-9b's D and a window
    (1, 55, 300, 20, 20, 64, False, 0),      # cross, Sq < Sk
    (1, 1, 700, 16, 1, 256, False, 0),       # Sq 1 (a decode step)
    (1, 1, 300, 4, 4, 128, True, 0),         # Sq 1, causal: key 0 alone
    (1, 200, 100, 8, 2, 64, True, 30),       # a window past every key of the last rows
    (1, 140, 60, 4, 2, 256, True, 25),
    (2, 90, 90, 4, 2, 5, True, 1),           # every row sees one key
    (1, 129, 129, 8, 1, 160, False, 40),     # a window without causality
]


def float64_attention(q, k, v, gy, causal, window, scale):
    """K4's function in float64, the plain version's arithmetic (masked
    scores at MASK_VALUE, so a row that sees no key averages every key),
    and with ``gy`` its gradient by autograd: (o, dq, dk, dv) in float64."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kvh, h // kvh, d) * scale, k)
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    p = torch.softmax(s.masked_fill(~keep, fk.MASK_VALUE), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, sq, h, d)
    if gy is None:
        return (o.detach(),)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), gy.double()))


def f32_error_ratio(got, want):
    """The largest |got - want| / (atol + rtol |want|) at K4's f32
    tolerance (2e-4 / 2e-5): 1 is the tolerance's edge."""
    want = want.double()
    return float(((got.double() - want).abs() / (2e-5 + 2e-4 * want.abs())).max())


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", F32_SHAPES)
def test_k4_f32_forward_and_backward_against_float64(cuda, b, sq, sk, h, kvh, d, causal, window):
    """The f32 kernels (three bf16 pieces an operand) against the float64
    function: no worse than the larger of a tenth of the f32 tolerance and
    twice the plain f32 version's own error (``f32_error_ratio``), and
    within the tolerance of the plain version; the forward counts one launch
    in ``f32_launches``, the backward one in ``f32_backward_launches``; two
    calls give the same bits, and where every row sees one key dQ is 0 to
    the bit."""
    q, k, v = attention_inputs(b, sq, sk, h, kvh, d, torch.float32, cuda, seed=sq + sk + d)
    gy = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (b, sq, h, d), dtype=np.float32)).to(cuda)
    scale = d**-0.5
    mask = dict(causal=causal, window=window)
    n, nf = fk.flash_attention.launches, fk.flash_attention.f32_launches
    out, stats = fk._launch(q, k, v, causal, window, scale, stats=True)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches, fk.flash_attention.f32_launches) == (n + 1, nf + 1)
    nb, nfb = fk.flash_attention.backward_launches, fk.flash_attention.f32_backward_launches
    grads = fk.flash_attention_backward(q, k, v, stats, gy, scale=scale, **mask)
    torch.cuda.synchronize()
    assert (fk.flash_attention.backward_launches,
            fk.flash_attention.f32_backward_launches) == (nb + 1, nfb + 1)
    want = float64_attention(q, k, v, gy, causal, window, scale)
    plain = fk.flash_attention_plain(q, k, v, stats=True, scale=scale, **mask)
    plain_grads = fk.flash_attention_backward_plain(q, k, v, plain[1], plain[2], gy,
                                                    scale=scale, **mask)
    for name, got, p, w in zip(("o", "dq", "dk", "dv"), (out, *grads), (plain[0], *plain_grads),
                               want):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), name
        assert within_tol(got, p, torch.float32), name
        ratio, plain_ratio = f32_error_ratio(got, w), f32_error_ratio(p, w)
        assert ratio <= max(0.1, 2 * plain_ratio), (name, ratio, plain_ratio)
    again = fk._launch(q, k, v, causal, window, scale, stats=True)
    assert torch.equal(again[0], out) and torch.equal(again[1], stats)
    again = fk.flash_attention_backward(q, k, v, stats, gy, scale=scale, **mask)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))
    if causal and window == 1:
        assert bool((grads[0] == 0).all())


def test_k4_f32_launches_count_one_call(cuda):
    # one f32 call through the Function: one forward launch, counted in
    # launches and f32_launches; its backward one in backward_launches and
    # f32_backward_launches; bf16 counts in neither f32 count
    q, k, v = (x.requires_grad_() for x in attention_inputs(1, 100, 100, 4, 2, 64,
                                                             torch.float32, cuda))
    counts = ("launches", "f32_launches", "backward_launches", "f32_backward_launches")
    before = [getattr(fk.flash_attention, c) for c in counts]
    fk.flash_attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert [getattr(fk.flash_attention, c) - n for c, n in zip(counts, before)] == [1, 1, 1, 1]
    qb, kb, vb = (x.detach().bfloat16().requires_grad_() for x in (q, k, v))
    before = [getattr(fk.flash_attention, c) for c in counts]
    fk.flash_attention(qb, kb, vb).float().sum().backward()
    torch.cuda.synchronize()
    assert [getattr(fk.flash_attention, c) - n for c, n in zip(counts, before)] == [1, 0, 1, 0]


def test_k4_f32_library_refuses_unpadded_head_dims(cuda):
    # the f32 kernels' 16-byte loads take D % 4 == 0 alone: the wrapper pads
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = _build.function("flash_attention_f32", "flash_attention_f32_launch", fk._ARGS)
    err = fwd(q.data_ptr(), q.data_ptr(), q.data_ptr(), torch.empty_like(q).data_ptr(),
              1, 64, 64, 2, 2, 6, 1, 0, 1.0, None, stream)
    assert err == 1  # D % 4 != 0: cudaErrorInvalidValue


def ssd_inputs(b, s, h, p, n, device, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)  # noqa: E731
    x = f(b, s, h, p)
    log_a = torch.from_numpy(-0.2 * rng.random((b, s, h), np.float32)).to(device)
    h0 = 0.5 * f(b, h, p, n) if with_h0 else None
    return x, log_a, 0.3 * f(b, s, n), 0.3 * f(b, s, n), h0


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 8, 16, 32),
    (1, 96, 1, 32, 32, 32),
    (1, 100, 2, 20, 16, 32),           # ragged S and a partial P block
    (1, 1000, 24, 64, 128, 256),       # mamba2's prefill, ragged
    (1, 300, 2, 80, 200, 64),          # two P tiles, two N blocks, a partial slab
] + [
    # lengths around the kernels' sub-chunk of 64 and mamba2's chunk of 256,
    # the longest served prompt (891) and the full context, in batch 2, at
    # mamba2's widths and a narrower head
    (2, s, h, p, n, chunk)
    for s in (1, 63, 64, 65, 255, 256, 257, 891, 2048)
    for chunk in (64, 256)
    for h, p, n in ((24, 64, 128), (3, 20, 16))
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_k5_matches_plain(cuda, b, s, h, p, n, chunk, with_h0):
    x, log_a, bm, cm, h0 = ssd_inputs(b, s, h, p, n, cuda, seed=s, with_h0=with_h0)
    before = ssk.ssd_scan.launches
    y, hf = ssk.ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0)
    assert ssk.ssd_scan.launches == before + 1
    y_want, h_want = ssk.ssd_scan_plain(x, log_a, bm, cm, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, y_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(hf, h_want, rtol=2e-4, atol=2e-4)


# -- K4 and K5 carry gradients ------------------------------------------------
def within_tol(got, want, dtype):
    """K4's tolerance of phase 4 in ``chip_smoke.py``: f32 2e-4 / 2e-5; bf16
    rtol 2e-2 with an atol of 2e-2 of the RMS of each expected row (the
    last dim)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        rtol, atol = 2e-4, 2e-5
    else:
        rtol, atol = 2e-2, 2e-2 * want.pow(2).mean(-1, keepdim=True).sqrt()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def grads_through(fn, inputs, weights):
    """(outputs, input gradients) of sum(output · weight) through ``fn``."""
    leaves = [x.clone().requires_grad_() if x is not None else None for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.requires_grad for o in outs)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    return outs, [x.grad if x is not None else None for x in leaves]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 300, 300, 4, 1, 128, True, 64),
    (1, 55, 150, 4, 4, 64, False, 0),
    (1, 200, 200, 4, 2, 160, True, 0),
    (1, 2048, 2048, 32, 4, 64, True, 0),   # tinyllama's training rows, at B 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_function_gradients_match_autograd_of_plain(cuda, b, sq, sk, h, kvh, d, causal,
                                                      window, dtype):
    q, k, v = attention_inputs(b, sq, sk, h, kvh, d, dtype, cuda, seed=sq + d)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, sq, h, d), dtype=np.float32)).to(cuda)
    mask = dict(causal=causal, window=window)
    n, nb = fk.flash_attention.launches, fk.flash_attention.backward_launches
    out, grads = grads_through(lambda *x: fk.flash_attention(*x, **mask), (q, k, v), [w])
    assert fk.flash_attention.launches == n + 1
    assert fk.flash_attention.backward_launches == nb + 1
    want_out, want = grads_through(lambda *x: fk.flash_attention_plain(*x, **mask),
                                   (q, k, v), [w])
    assert within_tol(out[0], want_out[0], dtype)
    for name, g, gw in zip("qkv", grads, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        assert within_tol(g, gw, dtype), name


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 100, 3, 8, 16, 32),
    (1, 891, 24, 64, 128, 256),
    (4, 2048, 24, 64, 128, 256),           # mamba2-130m's training microbatch
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_k5_function_gradients_match_autograd_of_plain(cuda, b, s, h, p, n, chunk, with_h0):
    x, log_a, bm, cm, h0 = ssd_inputs(b, s, h, p, n, cuda, seed=s, with_h0=with_h0)
    rng = np.random.default_rng(2)
    w = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)
         for shape in ((b, s, h, p), (b, h, p, n))]
    before, nb = ssk.ssd_scan.launches, ssk.ssd_scan.backward_launches
    outs, grads = grads_through(lambda *a: ssk.ssd_scan(*a[:4], chunk=chunk, h0=a[4]),
                                (x, log_a, bm, cm, h0), w)
    assert ssk.ssd_scan.launches == before + 1
    assert ssk.ssd_scan.backward_launches == nb + 1
    want_outs, want = grads_through(lambda *a: ssk.ssd_scan_plain(*a[:4], chunk=chunk, h0=a[4]),
                                    (x, log_a, bm, cm, h0), w)
    for o, wo in zip(outs, want_outs):
        torch.testing.assert_close(o, wo, rtol=2e-4, atol=2e-4)
    for name, g, gw in zip(("x", "log_a", "B", "C", "h0"), grads, want):
        if gw is None:
            assert g is None and not with_h0 and name == "h0"
            continue
        torch.testing.assert_close(g, gw, rtol=2e-4, atol=2e-4, msg=name)


# -- the backward kernels against their plain versions -------------------------
K4_BACKWARD_SHAPES = [  # b, sq, sk, h, kvh, d, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 300, 300, 4, 1, 128, True, 64),
    (1, 55, 150, 4, 4, 64, False, 0),       # cross: no mask, Sq != Sk
    (2, 1, 300, 8, 1, 64, False, 0),        # a decode step: Sq 1, G 8
    (1, 200, 200, 4, 2, 160, True, 0),
    (1, 130, 130, 4, 1, 256, True, 33),
    (1, 129, 129, 4, 2, 256, False, 50),
    (1, 70, 70, 2, 1, 1, True, 0),          # D 1
    (2, 65, 65, 4, 2, 5, True, 0),          # D 5: the bf16 wrapper pads to 8
    (1, 100, 100, 4, 4, 100, False, 0),
    (1, 77, 77, 6, 3, 16, True, 9),         # ragged, odd group count
    (2, 120, 70, 4, 2, 32, True, 20),       # causal window past every key: masked rows
    (1, 90, 90, 16, 2, 24, True, 0),        # G 8
    (1, 2048, 2048, 32, 4, 64, True, 0),    # tinyllama's training rows, at B 1
    (2, 2048, 2048, 16, 2, 128, True, 0),   # a phase-9 rank's heads at D 128
    # the wgmma kernels' edges: padded widths D 8 and 80, ragged Sq != Sk
    # both ways (causal: top-left), G 1 and 8, masked rows at D 128
    (2, 77, 77, 4, 2, 8, True, 0),
    (1, 200, 130, 4, 2, 80, False, 0),
    (2, 100, 150, 4, 4, 64, True, 0),
    (1, 150, 100, 8, 1, 128, True, 0),
    (1, 200, 100, 8, 2, 128, True, 30),     # causal window past every key: masked rows
    (1, 129, 129, 8, 1, 64, False, 40),     # a window without causality
    # bf16 past D 128: the two-warpgroup kernels at padded widths 192 and
    # 256 (D 136 and 200 padded, 192 full), a one-kv-head grid short of a
    # wave whose key tiles walk split ranges, masked rows at D 256
    (1, 100, 100, 4, 2, 136, True, 0),
    (2, 150, 150, 8, 2, 192, True, 0),
    (1, 130, 90, 4, 4, 200, False, 0),
    (1, 1024, 1024, 16, 1, 256, True, 300),
    (1, 140, 60, 4, 2, 256, True, 25),      # causal window past every key: masked rows
]


def k4_backward_case(b, sq, sk, h, kvh, d, causal, window, dtype, device, seed=0):
    """Inputs, the forward kernel's statistics and dO for one backward."""
    q, k, v = attention_inputs(b, sq, sk, h, kvh, d, dtype, device, seed=seed)
    gy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, sq, h, d), dtype=np.float32)).to(device, dtype)
    out, stats = fk._launch(q, k, v, causal, window, d**-0.5, stats=True)
    return q, k, v, out, stats, gy


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", K4_BACKWARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_kernel_matches_plain(cuda, b, sq, sk, h, kvh, d, causal, window, dtype):
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    q, k, v, out, stats, gy = k4_backward_case(b, sq, sk, h, kvh, d, causal, window, dtype, cuda,
                                               seed=sq + d)
    _, m, l = fk.flash_attention_plain(q, k, v, stats=True, **mask)
    torch.testing.assert_close(stats[0], m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1], l, rtol=2e-4, atol=1e-5)
    n, nb = fk.flash_attention.launches, fk.flash_attention.backward_launches
    got = fk.flash_attention_backward(q, k, v, stats, gy, **mask)
    torch.cuda.synchronize()
    assert (fk.flash_attention.launches, fk.flash_attention.backward_launches) == (n, nb + 1)
    want = fk.flash_attention_backward_plain(q, k, v, stats[0], stats[1], gy, **mask)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert within_tol(g, w, dtype), name
    # two calls give the same bits (no atomics)
    again = fk.flash_attention_backward(q, k, v, stats, gy, **mask)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("d", [8, 64, 128, 160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_backward_one_key_rows_give_dq_exactly_zero(cuda, d, dtype):
    """A window of 1: every row sees its own key alone, so P = 1 and dS = 0
    exactly and dQ is 0 to the bit; each key's dV is its position's dO
    summed over the group.  A causal call's first row sees key 0 alone."""
    b, s, h, kvh = 2, 130, 4, 2
    for window in (1, 0):
        mask = dict(causal=True, window=window, scale=d**-0.5)
        q, k, v, _, stats, gy = k4_backward_case(b, s, s, h, kvh, d, True, window, dtype, cuda,
                                                 seed=d + window)
        dq, dk, dv = fk.flash_attention_backward(q, k, v, stats, gy, **mask)
        torch.cuda.synchronize()
        rows = dq if window else dq[:, :1]
        assert bool((rows == 0).all()), float(rows.float().abs().max())
        if window:
            want = gy.float().reshape(b, s, kvh, h // kvh, d).sum(3)
            assert within_tol(dv, want, dtype)
        again = fk.flash_attention_backward(q, k, v, stats, gy, **mask)
        assert all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))


@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 100, 3, 8, 16),        # a partial last sub-chunk
    (1, 64, 2, 16, 8),
    (1, 300, 2, 80, 200),      # two P tiles, four N slabs, a partial sub-chunk
    (2, 1, 4, 64, 128),
    (1, 891, 24, 64, 128),     # mamba2's longest served prompt
    (1, 1000, 24, 64, 128),    # a partial sub-chunk at mamba2's widths
    (4, 2048, 24, 64, 128),    # mamba2-130m's training microbatch
])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("through", ["y", "state", "both"])
def test_k5_backward_kernel_matches_plain(cuda, b, s, h, p, n, with_h0, through):
    x, log_a, bm, cm, h0 = ssd_inputs(b, s, h, p, n, cuda, seed=s + p, with_h0=with_h0)
    rng = np.random.default_rng(5)
    gy = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32)).to(cuda) \
        if through != "state" else None
    gh = torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32)).to(cuda) \
        if through != "y" else None
    n0, nb = ssk.ssd_scan.launches, ssk.ssd_scan.backward_launches
    got = ssk.ssd_scan_backward(x, log_a, bm, cm, h0, gy, gh)
    torch.cuda.synchronize()
    assert (ssk.ssd_scan.launches, ssk.ssd_scan.backward_launches) == (n0, nb + 1)
    want = ssk.ssd_scan_backward_plain(x, log_a, bm, cm, h0, gy, gh)
    for name, g, w in zip(("x", "log_a", "B", "C", "h0"), got, want):
        if w is None:
            assert g is None and name == "h0" and not with_h0
            continue
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=name)
    again = ssk.ssd_scan_backward(x, log_a, bm, cm, h0, gy, gh)
    assert all(torch.equal(a, g) for a, g in zip(again, got) if g is not None)


def test_smoke_train_step_through_kernels_matches_plain(cuda):
    """One tinyllama smoke() train step (f32) through K4 against plain=True:
    each layer launches K4 twice, in the forward and in remat's recomputation."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh_rules import MeshRules, MeshShape
    from repro_torch.tree import tree_leaves

    cfg = get_config("tinyllama-1.1b").smoke()
    rules = MeshRules(MeshShape((1, 1), ("data", "model")), cfg.parallel)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((4, 64), device=cuda)}
    shape = InputShape("t", 64, 4, "train")
    out = {}
    for plain in (False, True):
        model = make_model(cfg, device=cuda, plain=plain)
        params = model.init(0)
        opt = AdamW(cfg=cfg)
        step = make_train_step(model, opt, rules, shape, lr=1e-3, loss_chunk=0, microbatches=2)
        n = fk.flash_attention.launches
        grads, _ = step.grads(params, batch)
        launches = fk.flash_attention.launches - n
        out[plain] = (grads, step(params, opt.init(params), batch)[2], launches)
    assert out[False][2] == 2 * cfg.num_layers * 2 and out[True][2] == 0
    for key in ("loss", "ce_loss", "grad_norm"):
        torch.testing.assert_close(out[False][1][key], out[True][1][key], rtol=1e-5, atol=0)
    gmax = max(float(g.abs().max()) for g in tree_leaves(out[True][0]))
    for g, gw in zip(tree_leaves(out[False][0]), tree_leaves(out[True][0])):
        torch.testing.assert_close(g, gw, rtol=0, atol=1e-4 * gmax)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m", "stablelm-12b",
                                  "qwen3-moe-30b-a3b"])
def test_smoke_model_kernels_match_plain(cuda, arch):
    cfg = get_config(arch).smoke()
    model, plain = make_model(cfg, device=cuda), make_model(cfg, device=cuda, plain=True)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 29))).to(cuda)
    got, c_got = model.prefill(params, tokens, 64)
    want, c_want = plain.prefill(params, tokens, 64)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    step = torch.tensor([[5]], device=cuda)
    pos = torch.tensor([[29]], device=cuda)
    torch.testing.assert_close(model.decode_step(params, step, pos, c_got)[0],
                               plain.decode_step(params, step, pos, c_want)[0],
                               rtol=2e-4, atol=2e-4)


def test_moe_smoke_served_kernels_equal_plain(cuda):
    # qwen3-moe's smoke() (f32, 4 experts, top-2, capacity chunks with
    # overflow to the fallback) served through the engine with K4 and with
    # its plain version: every greedy token equal
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    params = make_model(cfg, device=cuda).init(5)
    rng = np.random.default_rng(6)
    specs = [(rid, rng.integers(0, cfg.vocab_size, int(rng.integers(10, 60))), 8)
             for rid in range(6)]

    def serve(plain):
        engine = ServingEngine(make_model(cfg, device=cuda, plain=plain), params, slots=2,
                               max_len=96)
        for rid, prompt, mx in specs:
            engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
        return {rid: r.tokens for rid, r in engine.run().items()}

    n = fk.flash_attention.launches
    got = serve(False)
    assert fk.flash_attention.launches - n == cfg.num_layers * len(specs)
    assert got == serve(True)
    assert all(len(t) == 8 for t in got.values())


def test_hybrid_smoke_served_kernels_equal_plain(cuda):
    # recurrentgemma-9b's smoke() (f32, window 8) through the engine with K4
    # and with its plain version: prompts past the window roll the cache;
    # only the attn layers launch K4, once per prefill
    cfg = get_config("recurrentgemma-9b").smoke()
    params = make_model(cfg, device=cuda).init(5)
    rng = np.random.default_rng(7)
    specs = [(rid, rng.integers(0, cfg.vocab_size, int(rng.integers(3, 40))), 8)
             for rid in range(6)]

    def serve(plain):
        engine = ServingEngine(make_model(cfg, device=cuda, plain=plain), params, slots=2,
                               max_len=64)
        for rid, prompt, mx in specs:
            engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
        return {rid: r.tokens for rid, r in engine.run().items()}

    n = fk.flash_attention.launches
    got = serve(False)
    attn_layers = transformer.layer_kinds(cfg).count("attn")
    assert fk.flash_attention.launches - n == attn_layers * len(specs)
    assert got == serve(True)
    assert all(len(t) == 8 for t in got.values())


def greedy(model, params, prompt, steps, **source):
    """Batch-1 prefill and ``steps`` greedy decode steps -> the tokens."""
    logits, caches = model.prefill(params, prompt, 64, **source)
    tokens = [int(logits.argmax())]
    for i in range(steps):
        tok = torch.tensor([[tokens[-1]]], device=prompt.device)
        pos = torch.tensor([[prompt.shape[1] + i]], device=prompt.device)
        logits, caches = model.decode_step(params, tok, pos, caches)
        tokens.append(int(logits.argmax()))
    return tokens


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_cross_family_smoke_kernels_equal_plain(cuda, arch):
    # whisper's smoke() (encoder, causal decoder self-attention, cross
    # attention) and the vision model's (cross gates opened to 0.5: at 0
    # the cross path is multiplied away) with K4 and with its plain
    # version: greedy tokens equal; K4 launches per prefill and per step
    cfg = get_config(arch).smoke()
    model, plain = make_model(cfg, device=cuda), make_model(cfg, device=cuda, plain=True)
    params = model.init(5)
    rng = np.random.default_rng(8)
    if cfg.family == "encdec":
        shape, key = (1, cfg.encoder_seq, cfg.d_model), "frames"
        per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
        per_step = cfg.num_layers
    else:
        for layer in params["layers"]:
            if "gate_attn" in layer:
                layer["gate_attn"].fill_(0.5)
                layer["gate_mlp"].fill_(0.5)
        shape, key = (1, cfg.num_image_tokens, cfg.d_model), "image_embeds"
        kinds = transformer.layer_kinds(cfg)
        per_step = kinds.count("cross")
        per_prefill = len(kinds) + per_step
    for rid in range(3):
        source = {key: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)}
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 5 + 9 * rid))).to(cuda)
        n = fk.flash_attention.launches
        got = greedy(model, params, prompt, 8, **source)
        assert fk.flash_attention.launches - n == per_prefill + 8 * per_step
        assert got == greedy(plain, params, prompt, 8, **source)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_full_width_serve(cuda, arch):
    cfg = get_config(arch)
    model = make_model(cfg, device=cuda)
    params = model.init(0)
    engine = ServingEngine(model, params, slots=2, max_len=512)
    rng = np.random.default_rng(0)
    for rid in range(3):
        engine.submit(Request(rid=rid, max_new_tokens=4,
                              prompt=rng.integers(0, cfg.vocab_size, 100 + 37 * rid)))
    results = engine.run()
    assert sorted(results) == [0, 1, 2]
    assert all(r.ok and len(r.tokens) == 4 for r in results.values())


# ---------------------------------------------------------------------------
# worker processes hosting cuda units
# ---------------------------------------------------------------------------
class K3RowBlocks:
    """Picklable work: K3 on row blocks ``a:b`` of a seeded problem, on the
    card of the process that runs it; returns the rows on the CPU."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, chunk=None):
        p = sref.make_problem(1000, 3000, 100, nnz_mean=120.0, seed=7)
        arrays = sk.BlockEllArrays(sref.to_block_ell(p), "cuda")
        rhs = torch.from_numpy(sops.pad_rhs(p)).cuda()
        return sk.spmm_block_ell(arrays.row_block_range(self.a, self.b), rhs).cpu()


def on_worker(address, work):
    unit = RemoteUnit("w0", address=address, remote_backend="cuda", max_retries=1200,
                      connect_timeout=120.0)
    bus = CompletionBus()
    unit.start(bus)
    try:
        unit.submit(Chunk(0, 1, "w0"), work)
        assert bus.wait(timeout=300.0)
        rec = bus.drain()[0]
    finally:
        unit.close()
    assert rec.error is None, rec.error
    return rec.result


@pytest.fixture
def cuda_worker(cuda):
    handle = spawn_worker(startup_timeout=120.0)
    try:
        yield handle
    finally:
        handle.kill()


def test_worker_runs_k3_rows_bitwise_equal_to_local(cuda_worker):
    on_worker(cuda_worker.address, LaunchCounts())  # zero the worker's counts
    got = on_worker(cuda_worker.address, K3RowBlocks(40, 97))
    assert on_worker(cuda_worker.address, LaunchCounts())["spmm_block_ell"] == 1
    assert got.shape == ((97 - 40) * 8, 128)
    assert torch.equal(got, K3RowBlocks(40, 97)())
    assert torch.equal(got, K3RowBlocks(0, 125)()[40 * 8:97 * 8])


def test_remote_prefill_equals_inline(cuda_worker):
    cfg = get_config("tinyllama-1.1b").smoke()
    model = make_model(cfg, device="cuda")
    params = model.init(3)
    rng = np.random.default_rng(4)
    specs = [(rid, rng.integers(0, cfg.vocab_size, int(rng.integers(20, 60))), 6)
             for rid in range(5)]

    def serve(**kw):
        engine = ServingEngine(model, params, slots=2, max_len=64, **kw)
        for rid, prompt, mx in specs:
            engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mx))
        return {rid: r.tokens for rid, r in engine.run().items()}, engine

    on_worker(cuda_worker.address, LaunchCounts())
    inline, _ = serve()
    remote, engine = serve(backend=f"remote:{cuda_worker.address}",
                           model_spec={"config": cfg, "seed": 3})
    assert remote == inline
    assert engine.model_spec["device"] == "cuda"
    assert on_worker(cuda_worker.address, LaunchCounts())["flash_attention"] == \
        cfg.num_layers * len(specs)


# -- slice F1: two gloo ranks on the one card ---------------------------------
def _gloo_cuda_rank(rank: int, world: int, tmp: str) -> None:
    """The collectives of ``Group`` on CUDA tensors of two gloo ranks, and
    one sharded smoke() train step against the one-device step."""
    import json
    import pathlib

    import torch.distributed as dist

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.parallel import Group, MeshRules, MeshShape, compressed_psum

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        g = Group()
        v = (torch.arange(6, dtype=torch.float32, device="cuda") + 10 * rank)
        out = {"all_gather": g.all_gather(v.reshape(2, 3)).cpu().tolist(),
               "reduce_scatter": g.reduce_scatter(torch.stack([v + k for k in range(world)]))
               .cpu().tolist(),
               "broadcast": g.broadcast(v.clone(), world - 1).cpu().tolist(),
               "psum": compressed_psum(v, g).cpu().tolist()}
        if rank == 0:
            g.send(v, 1)
        else:
            out["recv"] = g.recv(torch.empty(6, device="cuda"), 0).cpu().tolist()
        out["staged_bytes"] = g.staged_bytes
        cfg = get_config("mamba2-130m").smoke()
        model = make_model(cfg, device="cuda")
        params = model.init(0)
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65))).cuda()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "mask": torch.ones((4, 64), device="cuda")}
        shape = InputShape("t", 64, 4, "train")
        opt = AdamW(cfg=cfg)
        two = make_train_step(model, opt, MeshRules(make_mesh((world, 1)), cfg.parallel), shape,
                              loss_chunk=0, microbatches=1)
        n = ssk.ssd_scan.launches
        shards = two.shard(params)
        _, _, m2 = two(shards, opt.init(shards), batch)
        out["launches"] = ssk.ssd_scan.launches - n
        one = make_train_step(model, opt, MeshRules(MeshShape((1, 1), ("data", "model")),
                                                    cfg.parallel),
                              shape, loss_chunk=0, microbatches=2)
        _, _, m1 = one(params, opt.init(params), batch)
        out["metrics"] = [{k: float(m[k]) for k in ("loss", "grad_norm")} for m in (m2, m1)]
        out["step_staged_bytes"] = two.group.staged_bytes
        pathlib.Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0: the collectives on CUDA tensors give the
    same results as on the host; only send and recv are staged, and count
    their bytes; a sharded mamba2 smoke() step launches K5, stages
    nothing, and equals the one-device step with 2 microbatches."""
    import json

    import torch.multiprocessing as mp

    mp.spawn(_gloo_cuda_rank, args=(2, str(tmp_path)), nprocs=2)
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    v = [np.arange(6, dtype=np.float32) + 10 * r for r in range(2)]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["all_gather"], np.stack(v).reshape(2, 2, 3))
        np.testing.assert_array_equal(out["reduce_scatter"], v[0] + v[1] + 2 * r)
        np.testing.assert_array_equal(out["broadcast"], v[1])
        np.testing.assert_allclose(out["psum"], v[0] + v[1], rtol=0.02, atol=0.02 * 15)
        assert out["staged_bytes"] == 24    # rank 0's send, rank 1's recv
        assert out["launches"] == 2 * get_config("mamba2-130m").smoke().num_layers
        two, one = out["metrics"]
        np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(two["grad_norm"], one["grad_norm"], rtol=1e-4)
        assert out["step_staged_bytes"] == 0


@pytest.mark.parametrize("h,kvh,d", [(32, 4, 64), (32, 4, 128)])   # tinyllama, qwen3-moe
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_on_a_model_ranks_heads(cuda, h, kvh, d, dtype):
    """What a model axis of 2 hands K4: each rank's 16 query heads with the
    2 kv heads they read give those heads of the full call, bitwise (a
    block computes one kv head's group of query heads)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s = 2, 512
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, kvh, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    full = fk.flash_attention(q, k, v, causal=True)
    for rank in range(2):
        qs, ks = slice(rank * h // 2, (rank + 1) * h // 2), slice(rank * kvh // 2,
                                                                (rank + 1) * kvh // 2)
        part = fk.flash_attention(q[:, :, qs].contiguous(), k[:, :, ks].contiguous(),
                                  v[:, :, ks].contiguous(), causal=True)
        assert torch.equal(part, full[:, :, qs])


def test_vocab_parallel_cross_entropy_in_two_halves(cuda):
    """The loss's vocab-parallel cross-entropy, each half of a vocabulary of
    32000 on its own thread (a group of two ranks emulated in one
    process), equals the plain loss; the hidden state's
    gradient (the two halves' sum) and each half's head gradient equal
    autograd's of the plain loss."""
    import threading
    import types

    from test_torch_dist_train_tp import ThreadGroup

    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.models.model_factory import _vocab_parallel_loss

    g = torch.Generator(device="cuda").manual_seed(4)
    vocab, d = 32000, 256
    hidden = torch.randn((2, 64, d), generator=g, device="cuda")
    head = 0.05 * torch.randn((d, vocab), generator=g, device="cuda")
    labels = torch.randint(0, vocab, (2, 64), generator=g, device="cuda")
    mask = (torch.rand((2, 64), generator=g, device="cuda") > 0.2).float()
    h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
    want, _ = cross_entropy_loss(h @ w, labels, mask)
    want.backward()
    shared = ([None, None], threading.Barrier(2))
    out = [None, None]

    def rank(r):
        group = ThreadGroup(r, 2, shared)
        tp = types.SimpleNamespace(group=group, rank=r, size=2)
        hr = hidden.clone().requires_grad_(True)
        wr = head[:, r * vocab // 2:(r + 1) * vocab // 2].clone().requires_grad_(True)
        loss = _vocab_parallel_loss(hr, wr, labels, mask, tp, chunk=32)
        loss.backward()
        out[r] = (loss.detach(), hr.grad, wr.grad)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(2):
        torch.testing.assert_close(out[r][0], want.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(out[r][2], w.grad[:, r * vocab // 2:(r + 1) * vocab // 2],
                                   rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(out[0][1] + out[1][1], h.grad, rtol=1e-4, atol=1e-7)

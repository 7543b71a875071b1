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
here, and a remote prefill equals the inline one.
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
from repro_torch.models import make_model  # noqa: E402
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_smoke_model_kernels_match_plain(cuda, arch):
    cfg = get_config(arch).smoke()
    if cfg.family == "dense":
        cfg = cfg.replace(head_dim=16)  # K4 takes head_dim 16-128
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
    cfg = get_config("tinyllama-1.1b").smoke().replace(head_dim=16)  # K4 takes 16-128
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

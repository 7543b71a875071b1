"""The port's CUDA kernels, CUDA stream units and model path, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the reference package, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

K1 and K2 evaluate the plain oracle's operations in its order and K3 sums
in its plain version's order, so each kernel is held to its plain version
bitwise; the kernels' outputs are also held against the oracles at the
reference's tolerances.  K4 and K5 sum in other orders than their plain
versions and are held to them at the reference tests' tolerances (f32
2e-4, bf16 2e-2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_eneac import HotspotConfig  # noqa: E402
from repro_torch.core import CompletionBus, CudaStreamUnit, HeteroRuntime, WorkerKind  # noqa: E402
from repro_torch.core.parallel_for import SplitDecision  # noqa: E402
from repro_torch.core.scheduler import Chunk  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.kernels.hotspot import hotspot as hk  # noqa: E402
from repro_torch.kernels.hotspot import ops as hops  # noqa: E402
from repro_torch.kernels.hotspot import ref as href  # noqa: E402
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


def grids(n, device, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(80.0 + 10.0 * rng.random((n, n), np.float32)).to(device),
            torch.from_numpy(rng.random((n, n), np.float32)).to(device))


@pytest.mark.parametrize("grid,steps", [(64, 1), (256, 8), (2048, 8)])
def test_k1_matches_plain(cuda, grid, steps):
    t, p = grids(grid, cuda)
    cfg = HotspotConfig(grid=grid)
    n = hk.hotspot_hpc.launches
    got = hk.hotspot_hpc(t, p, cfg, steps)
    assert hk.hotspot_hpc.launches == n + 1
    assert torch.equal(got, hk.hotspot_hpc_plain(t, p, cfg, steps))
    torch.testing.assert_close(got, href.hotspot_ref(t, p, cfg, steps), **HOTSPOT_TOL)


def test_k1_band_with_full_grid_coefficients(cuda):
    t, p = grids(256, cuda)
    cfg = HotspotConfig(grid=256)
    band, pband = t[63:130].contiguous(), p[63:130].contiguous()
    got = hk.hotspot_hpc(band, pband, cfg, 1, grid=(256, 256))
    assert torch.equal(got[1:-1], href.hotspot_step_ref(t, p, cfg)[64:129])


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

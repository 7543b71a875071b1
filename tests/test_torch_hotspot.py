"""HOTSPOT in the PyTorch port against the JAX reference.

The same numpy-seeded grids go through ``repro.kernels.hotspot`` (Pallas
kernels in interpret mode, as ``test_kernels.py`` runs them) and
``repro_torch.kernels.hotspot`` on the CPU, where the port's wrappers take
their kernels' plain versions.  Tolerances are the reference's own
(rtol 1e-5, atol 1e-4, ``test_kernels.py``); banded against whole-grid
stepping inside the port is bitwise.  The CUDA kernels are held against
their plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_eneac import HotspotConfig as JaxHotspotConfig  # noqa: E402
from repro.kernels.hotspot import ops as jax_ops  # noqa: E402
from repro.kernels.hotspot import ref as jax_ref  # noqa: E402
from repro_torch.configs.paper_eneac import HOTSPOT, HotspotConfig  # noqa: E402
from repro_torch.core import HeteroRuntime, TiledSpace, WorkerKind  # noqa: E402
from repro_torch.kernels.hotspot import hotspot as kern  # noqa: E402
from repro_torch.kernels.hotspot import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's parallel workers share the host with wall-clock timing
    tests, so these tests keep PyTorch's CPU ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(n, seed=0):
    rng = np.random.default_rng(seed)
    return (80.0 + 10.0 * rng.random((n, n), np.float32),
            rng.random((n, n), np.float32))


def test_config_copied_verbatim():
    assert HotspotConfig() == HOTSPOT
    assert vars(HotspotConfig(grid=64)) == vars(JaxHotspotConfig(grid=64))


@pytest.mark.parametrize("grid", [32, 64, 128, 2048, 100])
def test_coefficients_equal_jax(grid):
    cfg, jcfg = HotspotConfig(grid=grid), JaxHotspotConfig(grid=grid)
    assert ref.hotspot_coefficients(cfg, grid, grid // 2) == \
        jax_ref.hotspot_coefficients(jcfg, grid, grid // 2)


@pytest.mark.parametrize("grid,steps", [(32, 1), (64, 4), (128, 2)])
@pytest.mark.parametrize("mode", ["cc", "hp", "hpc"])
def test_modes_match_jax(grid, steps, mode):
    t, p = grids(grid, seed=grid + steps)
    jcfg = JaxHotspotConfig(grid=grid, iterations=grid)
    want = np.asarray(jax_ops.hotspot(jnp.asarray(t), jnp.asarray(p), jcfg, steps, mode=mode))
    cfg = HotspotConfig(grid=grid, iterations=grid)
    got = ops.hotspot(torch.from_numpy(t), torch.from_numpy(p), cfg, steps, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["hp", "hpc"])
def test_plain_kernel_versions_equal_oracle_bitwise(mode):
    # K1/K2 evaluate the oracle's operations in its order, so on the CPU
    # (their plain versions) they give hotspot_ref's bits
    t, p = grids(64, seed=5)
    cfg = HotspotConfig(grid=64)
    tt, pp = torch.from_numpy(t), torch.from_numpy(p)
    assert torch.equal(ops.hotspot(tt, pp, cfg, 3, mode=mode), ref.hotspot_ref(tt, pp, cfg, 3))


def k1_schedule(temp, power, cfg, steps, depth, *, tile_rows=32, region_cols=128):
    """K1's schedule (``csrc/hotspot.cu`` ``hpc_kernel``) in tensor ops.

    The same phases (as few as ``depth`` allows, of equal depth d), the
    same tiling (at most ``tile_rows`` rows and ``region_cols - 2d`` columns
    a tile, shared out evenly) and the same halos ``kk`` cells deep clipped
    at the grid's edges, ``kk`` the steps of the phase.
    Step s keeps only the region less s cells on each side that is not a
    grid edge; every other cell becomes NaN, so a cell computed from a cell
    the schedule never computed cannot go unnoticed.
    """
    rows, cols = temp.shape
    coeff = ref.hotspot_coefficients(cfg, rows, cols)
    d = -(-steps // -(-steps // depth))
    tiles_c = -(-cols // (region_cols - 2 * d))
    tile_cols = -(-cols // tiles_c)
    tile_rows = -(-rows // -(-rows // tile_rows))
    src = temp
    for ph in range(-(-steps // d)):
        kk = min(d, steps - ph * d)
        dst = torch.full_like(src, float("nan"))
        for r0 in range(0, rows, tile_rows):
            for c0 in range(0, cols, tile_cols):
                r1, c1 = min(r0 + tile_rows, rows), min(c0 + tile_cols, cols)
                R0, R1 = max(r0 - kk, 0), min(r1 + kk, rows)
                C0, C1 = max(c0 - kk, 0), min(c1 + kk, cols)
                assert C1 - C0 <= region_cols
                cur, pw = src[R0:R1, C0:C1], power[R0:R1, C0:C1]
                for step in range(1, kk + 1):
                    new = ref.hotspot_step_coeffs(cur, pw, cfg.amb_temp, *coeff)
                    ra, rb = (step if R0 > 0 else 0), R1 - R0 - (step if R1 < rows else 0)
                    ca, cb = (step if C0 > 0 else 0), C1 - C0 - (step if C1 < cols else 0)
                    cur = torch.full_like(new, float("nan"))
                    cur[ra:rb, ca:cb] = new[ra:rb, ca:cb]
                dst[r0:r1, c0:c1] = cur[r0 - R0:r1 - R0, c0 - C0:c1 - C0]
        src = dst
    return src


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
@pytest.mark.parametrize("rows,cols,tile_rows,region_cols,steps", [
    (37, 45, 8, 24, 5),        # tiles that do not divide the grid, several phases
    (70, 260, 32, 128, 9),     # the kernel's own tile sizes
    (3, 3, 2, 20, 4),          # every halo touches an edge
    (1, 5, 1, 20, 3),
])
def test_k1_temporal_blocking_equals_oracle_bitwise(depth, rows, cols, tile_rows, region_cols,
                                                    steps):
    rng = np.random.default_rng(rows * cols + depth)
    t = torch.from_numpy(80.0 + 10.0 * rng.random((rows, cols), np.float32))
    p = torch.from_numpy(rng.random((rows, cols), np.float32))
    cfg = HotspotConfig(grid=max(rows, cols))
    got = k1_schedule(t, p, cfg, steps, depth, tile_rows=tile_rows, region_cols=region_cols)
    assert torch.equal(got, ref.hotspot_ref(t, p, cfg, steps))


def test_rows_chunk_matches_jax_at_one_step():
    # the 1-row halo is exact for steps=1 only, so parity is held there
    t, p = grids(64, seed=3)
    cfg, jcfg = HotspotConfig(grid=64), JaxHotspotConfig(grid=64)
    lo, hi = 16, 40
    got = ops.hotspot_rows_chunk(torch.from_numpy(t[lo - 1:hi + 1]),
                                 torch.from_numpy(p[lo:hi]), cfg, 1)
    want = jax_ops.hotspot_rows_chunk(jnp.asarray(t[lo - 1:hi + 1]), jnp.asarray(p[lo:hi]),
                                      jcfg, 1)
    assert got.shape == (hi - lo, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_banded_bitwise_through_runtime_threads():
    R = C = 64
    band = 8
    cfg = HotspotConfig(grid=R, iterations=1)
    t_np, p_np = grids(R, seed=0)
    t, pw = torch.from_numpy(t_np), torch.from_numpy(p_np)
    expect = ref.hotspot_step_ref(t, pw, cfg)

    space = TiledSpace(grid=(R, C), tile=(band, C))
    out = torch.zeros((R, C), dtype=torch.float32)

    def work(chunk):
        for rs, _cs in space.chunk_slices(chunk):
            lo = max(rs.start - 1, 0)     # one halo row each side
            hi = min(rs.stop + 1, R)
            res = ops.hotspot_step_banded(t[lo:hi], pw[lo:hi], cfg, (R, C))
            out[rs] = res[rs.start - lo: rs.start - lo + (rs.stop - rs.start)]

    rt = HeteroRuntime()
    for i in range(3):
        rt.register_unit(f"cc{i}", WorkerKind.CC, work_fn=work)
    rep = rt.parallel_for(space=space, policy="multidynamic", engine="interrupt",
                          acc_chunk=2, backend="threads")
    assert rep.items == space.num_items
    assert torch.equal(out, expect), "banded stencil diverged from whole-grid step"
    want = jax_ref.hotspot_step_ref(jnp.asarray(t_np), jnp.asarray(p_np),
                                    JaxHotspotConfig(grid=R, iterations=1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("port", ["hp", "hpc"])
def test_hetero_steps_cover_once_and_equal_oracle(port):
    # Table-1 configs 5/7 on CPU tensors: CC threads plus CudaStreamUnit(cpu)
    R = 96
    cfg = HotspotConfig(grid=R, iterations=R)
    t_np, p_np = grids(R, seed=11)
    t, pw = torch.from_numpy(t_np), torch.from_numpy(p_np)
    run = ops.hotspot_hetero(t, pw, cfg, 3, port=port, acc_chunk=8)
    assert len(run.reports) == 3
    for rep in run.reports:
        assert rep.items == R
        spans = rep.coverage
        assert spans[0][0] == 0 and spans[-1][1] == R
        assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))
        assert set(rep.per_worker_items) == {f"acc{i}" for i in range(ops.N_ACC)} | {
            f"cc{i}" for i in range(ops.N_CC)}
    assert torch.equal(run.out, ref.hotspot_ref(t, pw, cfg, 3))
    want = jax_ref.hotspot_ref(jnp.asarray(t_np), jnp.asarray(p_np),
                               JaxHotspotConfig(grid=R, iterations=R), 3)
    np.testing.assert_allclose(run.out.numpy(), np.asarray(want), **TOL)
    assert run.d2h_seconds >= 0.0 and run.cc_writeback_seconds >= 0.0


def test_hetero_rejects_unknown_port():
    t = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="port"):
        ops.hotspot_hetero(t, t, HotspotConfig(grid=8), 1, port="axi")


def test_wrappers_take_plain_path_on_cpu_without_counting():
    t, p = (torch.from_numpy(a) for a in grids(32))
    cfg = HotspotConfig(grid=32)
    before = (kern.hotspot_hpc.launches, kern.hotspot_hp_step.launches)
    kern.hotspot_hpc(t, p, cfg, 2)
    kern.hotspot_hp_step(t, p, cfg)
    assert (kern.hotspot_hpc.launches, kern.hotspot_hp_step.launches) == before
    assert torch.equal(kern.hotspot_hpc(t, p, cfg, 0), t)


@pytest.mark.parametrize("bad", ["shape", "dtype", "empty"])
def test_wrappers_reject_bad_input(bad):
    cfg = HotspotConfig(grid=16)
    t = torch.zeros((16, 16))
    p = {"shape": torch.zeros((16, 8)), "dtype": torch.zeros((16, 16), dtype=torch.float64),
         "empty": torch.zeros((0, 16))}[bad]
    if bad == "empty":
        t = p
    with pytest.raises((ValueError, TypeError)):
        kern.hotspot_hpc(t, p, cfg, 1)
    with pytest.raises((ValueError, TypeError)):
        kern.hotspot_hp_step(t, p, cfg)


def test_mode_must_be_known():
    t = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="mode"):
        ops.hotspot(t, t, HotspotConfig(grid=8), 1, mode="fpga")


def test_sass_floor_counts_the_path_to_the_first_store():
    from repro_torch.kernels.hotspot import sass_floor

    sass = """
        Function : _ZN12_GLOBAL__N_19hpc_kernelEPKfS1_PfS2_
        /*0000*/                   FFMA R1, R2, R3, R4 ;                  /* 0x0000000000000000 */
        /*0010*/                   STG.E [R2.64], R1 ;                    /* 0x0000000000000000 */
        Function : _ZN12_GLOBAL__N_114hp_step_kernelEPKfS1_S1_S1_PfiiNS_5CoeffE
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x0000000000000000 */
        /*0010*/                   MUFU.RCP R3, R2 ;                      /* 0x0000000000000000 */
        /*0020*/              @!P0 FFMA R4, R3, R2, R5 ;                  /* 0x0000000000000000 */
        /*0030*/                   FCHK P0, R4, R2 ;                      /* 0x0000000000000000 */
        /*0040*/                   IMAD.WIDE R6, R0, 0x4, R6 ;            /* 0x0000000000000000 */
        /*0050*/                   STG.E [R6.64], R4 ;                    /* 0x0000000000000000 */
        /*0060*/                   FADD R8, R8, R9 ;                      /* 0x0000000000000000 */
        /*0070*/                   EXIT ;                                 /* 0x0000000000000000 */
    """
    path = sass_floor.per_cell_path(sass)
    assert "MOV" in path[0] and len(path) == 6 and "STG.E" in path[-1] and "@!P0 FFMA" in path[2]
    got = sass_floor.floor_ms(path, cell_steps=132 * 128 * 1000, sms=132, sm_mhz=1000.0)
    # 3 issue slots (MUFU, FFMA, FCHK) a cell, 1 MUFU at an eighth of the issue rate
    assert (got["fp_and_mufu_per_cell"], got["mufu_per_cell"]) == (3, 1)
    assert got["issue_ms"] == pytest.approx(3e-3) and got["mufu_ms"] == pytest.approx(8e-3)
    assert got["floor_ms"] == got["mufu_ms"]

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

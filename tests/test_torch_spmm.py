"""SPMM in the PyTorch port against the JAX reference.

Host formats must give identical arrays for the same seed; the kernel K3's
plain version, the CC gather path and the hybrid executor are held at the
reference's tolerance (1e-4, ``test_kernels.py``) against the Pallas
kernel in interpret mode, ``spmm_ell_ref`` and ``spmm_dense_ref``.  The
CUDA kernel is held against its plain version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.parallel_for import SplitDecision as JaxSplitDecision  # noqa: E402
from repro.kernels.spmm import ops as jax_ops  # noqa: E402
from repro.kernels.spmm import ref as jax_ref  # noqa: E402
from repro.kernels.spmm.spmm import BlockEllArrays as JaxBlockEllArrays  # noqa: E402
from repro.kernels.spmm.spmm import spmm_block_ell_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.parallel_for import SplitDecision  # noqa: E402
from repro_torch.kernels.spmm import ops, ref  # noqa: E402
from repro_torch.kernels.spmm import spmm as kern  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(40, 256, 16), (64, 384, 32), (17, 128, 8)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite's parallel workers share the host with wall-clock timing
    tests, so these tests keep PyTorch's CPU ops to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_block_ell_equal(a, b):
    for field in ("vals", "colblocks", "counts"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert (a.rows, a.n_cols) == (b.rows, b.n_cols)


@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("rows,cols,n", SHAPES + [(300, 2000, 20)])
def test_formats_identical_to_jax(rows, cols, n, seed):
    kw = dict(nnz_mean=6.0, nnz_sigma=1.0, seed=seed)
    p, jp = ref.make_problem(rows, cols, n, **kw), jax_ref.make_problem(rows, cols, n, **kw)
    for field in ("vals", "cols", "nnz", "rhs"):
        assert np.array_equal(getattr(p, field), getattr(jp, field)), field
    assert (p.n_cols, p.rows) == (jp.n_cols, jp.rows)
    assert_block_ell_equal(ref.to_block_ell(p), jax_ref.to_block_ell(jp))
    for k_cap in (1, 2, 3):
        assert_block_ell_equal(ref.to_block_ell(p, k_cap=k_cap),
                               jax_ref.to_block_ell(jp, k_cap=k_cap))
    assert np.array_equal(ops.pad_rhs(p), jax_ops.pad_rhs(jp))
    assert np.array_equal(ops.density_order(p), jax_ops.density_order(jp))
    np.testing.assert_allclose(ref.spmm_dense_ref(p), jax_ref.spmm_dense_ref(jp), rtol=0, atol=0)
    assert ref.to_block_ell(p).padding_ratio() == jax_ref.to_block_ell(jp).padding_ratio()


def test_block_ell_accumulates_duplicates_in_loop_order():
    # a hand-built problem with a repeated column: values add, as the
    # reference's loop does, and empty rows give count 0
    vals = np.array([[1.5, 2.25, 0.0], [0.0, 0.0, 0.0], [3.0, -1.0, 7.0]], np.float32)
    cols = np.array([[5, 5, 0], [0, 0, 0], [130, 1, 260]], np.int32)
    nnz = np.array([2, 0, 3], np.int32)
    rhs = np.ones((300, 4), np.float32)
    p = ref.SpmmProblem(vals=vals, cols=cols, nnz=nnz, n_cols=300, rhs=rhs)
    jp = jax_ref.SpmmProblem(vals=vals, cols=cols, nnz=nnz, n_cols=300, rhs=rhs)
    assert_block_ell_equal(ref.to_block_ell(p), jax_ref.to_block_ell(jp))
    assert_block_ell_equal(ref.to_block_ell(p, k_cap=2), jax_ref.to_block_ell(jp, k_cap=2))


@pytest.mark.parametrize("rows,cols,n", SHAPES)
@pytest.mark.parametrize("nnz_mean", [2.0, 8.0])
def test_k3_plain_matches_pallas_kernel(rows, cols, n, nnz_mean):
    p = ref.make_problem(rows, cols, n, nnz_mean=nnz_mean, seed=rows + n)
    be = ref.to_block_ell(p)
    rhs_pad = ops.pad_rhs(p)
    got = kern.spmm_block_ell(kern.BlockEllArrays(be, "cpu"), torch.from_numpy(rhs_pad))
    want = spmm_block_ell_pallas(JaxBlockEllArrays(be), jnp.asarray(rhs_pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[:rows, :n].numpy(), ref.spmm_dense_ref(p), **TOL)


def test_k3_plain_independent_of_row_blocking():
    # the kernel's order (ascending columns, unfused) makes a row's result
    # independent of which rows share its block: the hybrid relies on this
    p = ref.make_problem(64, 512, 16, nnz_mean=12.0, seed=9)
    order = ops.density_order(p)
    sp = ref.SpmmProblem(vals=p.vals[order], cols=p.cols[order], nnz=p.nnz[order],
                         n_cols=p.n_cols, rhs=p.rhs)
    rhs = torch.from_numpy(ops.pad_rhs(p))
    a = kern.spmm_block_ell(kern.BlockEllArrays(ref.to_block_ell(p), "cpu"), rhs)
    b = kern.spmm_block_ell(kern.BlockEllArrays(ref.to_block_ell(sp), "cpu"), rhs)
    assert torch.equal(a[:64][torch.from_numpy(order)], b[:64])


def test_gather_path_matches_jax_and_dense_oracle(monkeypatch):
    p = ref.make_problem(32, 128, 8, nnz_mean=4.0, seed=7)
    want = np.asarray(jax_ops.spmm_cc(jnp.asarray(p.vals), jnp.asarray(p.cols),
                                      jnp.asarray(p.rhs)))
    args = (torch.from_numpy(p.vals), torch.from_numpy(p.cols), torch.from_numpy(p.rhs))
    got = ops.spmm_cc(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), ref.spmm_dense_ref(p), **TOL)
    # a tiny gather budget forces one ELL column per slab: same sums
    monkeypatch.setattr(ref, "_GATHER_ELEMS", 1)
    np.testing.assert_allclose(ops.spmm_cc(*args).numpy(), want, **TOL)


def test_gather_path_all_padding_rows_give_zeros():
    vals = torch.zeros((4, 3))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    out = ref.spmm_ell_ref(vals, cols, torch.ones((8, 5)))
    assert out.shape == (4, 5) and not out.any()


def test_hybrid_executor_exact_any_split():
    p = ref.make_problem(48, 256, 16, nnz_mean=6.0, seed=3)
    dense = ref.spmm_dense_ref(p)
    ex, order = ops.make_hybrid_executor(p, device="cpu")
    jex, jorder = jax_ops.make_hybrid_executor(jax_ref.make_problem(48, 256, 16, nnz_mean=6.0,
                                                                    seed=3))
    assert np.array_equal(order, jorder)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    for nd in (0, 16, 32, 48):
        res, d = ex.run(SplitDecision(n_dense=nd, n_sparse=48 - nd, predicted_time=0.0))
        assert res.device.type == "cpu" and res.shape == (48, 16)
        np.testing.assert_allclose(res.numpy()[inv], dense, **TOL)
        jres, _ = jex.run(JaxSplitDecision(n_dense=nd, n_sparse=48 - nd, predicted_time=0.0))
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), **TOL)


def test_hybrid_executor_converges_and_counts_no_cpu_launches():
    p = ref.make_problem(64, 256, 8, nnz_mean=6.0, seed=4)
    ex, order = ops.make_hybrid_executor(p, device="cpu")
    before = kern.spmm_block_ell.launches
    d = ex.converge(rounds=3)
    assert d.n_dense + d.n_sparse == 64 and d.n_dense % 8 == 0
    assert kern.spmm_block_ell.launches == before


def test_convert_round_trips_jax_block_ell():
    jp = jax_ref.make_problem(40, 256, 16, nnz_mean=8.0, seed=5)
    jbe = jax_ref.to_block_ell(jp)
    arrays = convert.block_ell_tensors(jbe, "cpu")
    assert arrays.vals.dtype == torch.float32 and arrays.colblocks.dtype == torch.int32
    assert_block_ell_equal(convert.block_ell_numpy(arrays), jbe)
    tensors = convert.spmm_problem_tensors(jp, "cpu")
    for name in ("vals", "cols", "nnz", "rhs"):
        assert np.array_equal(tensors[name].numpy(), getattr(jp, name)), name
    t, pw = convert.hotspot_grids(np.ones((4, 4)), np.zeros((4, 4)), "cpu")
    assert t.dtype == pw.dtype == torch.float32


def test_k3_rejects_out_of_range_column_blocks():
    p = ref.make_problem(16, 256, 8, nnz_mean=4.0, seed=1)
    arrays = kern.BlockEllArrays(ref.to_block_ell(p), "cpu")
    short_rhs = torch.zeros((128, 128))  # one column block; the matrix uses two
    with pytest.raises(ValueError, match="column block"):
        kern.spmm_block_ell(arrays, short_rhs)
    bad = ref.to_block_ell(p)
    bad.counts[0] = bad.k_max + 1
    with pytest.raises(ValueError, match="counts"):
        kern.BlockEllArrays(bad, "cpu")


def k3_zero_skipping_order(be, rhs):
    """K3's arithmetic in numpy: per row, k ascending, nonzero c ascending,
    each term a rounded f32 multiply and then a rounded f32 add."""
    n = rhs.shape[1]
    out = np.zeros((be.n_row_blocks * ref.ROW_BLOCK, n), np.float32)
    for rb in range(be.n_row_blocks):
        for r in range(ref.ROW_BLOCK):
            acc = np.zeros(n, np.float32)
            for k in range(int(be.counts[rb])):
                row = be.vals[rb, k, r]
                base = int(be.colblocks[rb, k]) * ref.COL_BLOCK
                for c in np.flatnonzero(row):  # -0.0 counts as zero, as the kernel's ballot does
                    acc = acc + row[c] * rhs[base + c]
            out[rb * ref.ROW_BLOCK + r] = acc
    return out


def cancelling_block_ell():
    # duplicates that cancel to 0.0 in a column block of their own (an
    # occupied block that holds only zeros), entries at columns 0 and 127 of
    # a block, an empty row, and -0.0 written over a third of the zeros
    # (to_block_ell sums into +0.0, so it never stores -0.0 itself)
    vals = np.array([[1.5, -1.5, 0.0, 0.0],
                     [0.5, 2.0, -3.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0],
                     [3.0, -0.25, 0.5, 1.0],
                     [-2.0, 4.0, 7.0, 0.0]], np.float32)
    cols = np.array([[260, 260, 0, 0], [0, 127, 255, 0], [0, 0, 0, 0],
                     [128, 255, 127, 5], [3, 4, 200, 0]], np.int32)
    nnz = np.array([2, 3, 0, 4, 3], np.int32)
    rhs = np.random.default_rng(11).standard_normal((384, 128)).astype(np.float32)
    p = ref.SpmmProblem(vals=vals, cols=cols, nnz=nnz, n_cols=384, rhs=rhs)
    be = ref.to_block_ell(p)
    assert be.counts[0] == 3 and not np.any(be.vals[0, 2])
    zeros = (be.vals == 0) & (np.arange(ref.COL_BLOCK) % 3 == 0)
    be.vals[zeros] = -0.0
    assert np.signbit(be.vals).sum() > 0
    return p, be


@pytest.mark.parametrize("case", ["paper_like", "narrow", "sparse", "cancelling"])
def test_k3_skipping_zeros_is_bitwise_the_plain_sum(case):
    # the CUDA kernel adds only the nonzero entries of each occupied block;
    # for finite rhs that is bitwise the plain version, which adds them all
    if case == "cancelling":
        p, be = cancelling_block_ell()
    else:
        rows, cols, n, nnz_mean, seed = {"paper_like": (200, 1500, 24, 20.0, 3),
                                         "narrow": (64, 384, 32, 8.0, 5),
                                         "sparse": (17, 128, 8, 2.0, 7)}[case]
        p = ref.make_problem(rows, cols, n, nnz_mean=nnz_mean, seed=seed)
        be = ref.to_block_ell(p)
    rhs_pad = ops.pad_rhs(p)
    got = k3_zero_skipping_order(be, rhs_pad)
    plain = kern.spmm_block_ell_plain(kern.BlockEllArrays(be, "cpu"), torch.from_numpy(rhs_pad))
    assert np.array_equal(got.view(np.uint32), plain.numpy().view(np.uint32))
    want = spmm_block_ell_pallas(JaxBlockEllArrays(be), jnp.asarray(rhs_pad))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)

"""Host-side SPMM formats (numpy) and the plain PyTorch gather oracle.

The counterpart of ``repro.kernels.spmm.ref``.  The paper's SPMM: sparse
(29957×29957) × dense (29957×100), iteration space = matrix rows,
irregular nnz/row.  Layouts:

* **ELL** (row-major, for the CC gather path): per-row padded
  ``(R, maxnnz)`` value/col arrays.
* **Block-ELL** (for the ACC kernel K3): rows grouped in blocks of 8,
  columns in blocks of 128; per row-block the list of occupied column
  blocks, padded to the per-matrix max.

:func:`make_problem`, :func:`spmm_dense_ref` and :func:`to_block_ell` give
the same arrays as the reference for the same inputs; :func:`to_block_ell`
is vectorised, and :func:`spmm_ell_ref` bounds its memory (it never forms
the ``(R, maxnnz, N)`` gather).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SpmmProblem", "make_problem", "spmm_dense_ref", "spmm_ell_ref",
    "BlockEll", "to_block_ell", "ROW_BLOCK", "COL_BLOCK",
]

ROW_BLOCK = 8
COL_BLOCK = 128

# Elements of one (rows, slab, N) gather in spmm_ell_ref: 128 MiB of f32.
_GATHER_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class SpmmProblem:
    """ELL-format sparse matrix + dense RHS."""

    vals: np.ndarray      # (R, maxnnz) f32, zero-padded
    cols: np.ndarray      # (R, maxnnz) int32, padded with 0 (vals 0 ⇒ no-op)
    nnz: np.ndarray       # (R,) int32
    n_cols: int
    rhs: np.ndarray       # (C, N) f32

    @property
    def rows(self) -> int:
        return self.vals.shape[0]


def make_problem(
    rows: int, cols: int, n_dense: int, *,
    nnz_mean: float = 8.0, nnz_sigma: float = 1.0, seed: int = 0,
) -> SpmmProblem:
    """Lognormal nnz/row — the irregular workload of the paper's §4."""
    rng = np.random.default_rng(seed)
    nnz = np.minimum(
        np.maximum(rng.lognormal(np.log(nnz_mean), nnz_sigma, rows).astype(np.int64), 1),
        cols,
    )
    maxnnz = int(nnz.max())
    vals = np.zeros((rows, maxnnz), np.float32)
    colix = np.zeros((rows, maxnnz), np.int32)
    for r in range(rows):
        k = int(nnz[r])
        colix[r, :k] = np.sort(rng.choice(cols, size=k, replace=False)).astype(np.int32)
        vals[r, :k] = rng.standard_normal(k).astype(np.float32)
    rhs = rng.standard_normal((cols, n_dense)).astype(np.float32)
    return SpmmProblem(vals=vals, cols=colix, nnz=nnz.astype(np.int32),
                       n_cols=cols, rhs=rhs)


def spmm_dense_ref(p: SpmmProblem) -> np.ndarray:
    """Densify + matmul — the ground-truth oracle (small problems only)."""
    dense = np.zeros((p.rows, p.n_cols), np.float32)
    for r in range(p.rows):
        k = int(p.nnz[r])
        np.add.at(dense[r], p.cols[r, :k], p.vals[r, :k])
    return dense @ p.rhs


def spmm_ell_ref(vals: torch.Tensor, cols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Row-gather path (the CC analogue): y = Σ_j vals[:, j]·rhs[cols[:, j]].

    The sum runs over slabs of ELL columns, each gathered as
    ``(R, slab, N)`` within a fixed element budget, and stops after the
    last column that holds a nonzero in any row: trailing columns are
    padding, whose zero values add nothing for finite data.
    """
    n_rows = vals.shape[0]
    n = rhs.shape[1]
    out = torch.zeros((n_rows, n), dtype=torch.float32, device=rhs.device)
    live = torch.nonzero((vals != 0).any(dim=0))
    width = int(live[-1]) + 1 if live.numel() else 0
    slab = max(1, _GATHER_ELEMS // max(n_rows * n, 1))
    for j0 in range(0, width, slab):
        j1 = min(j0 + slab, width)
        gathered = rhs[cols[:, j0:j1].long()]                     # (R, slab, N)
        out += torch.bmm(vals[:, j0:j1].unsqueeze(1), gathered).squeeze(1)
    return out


@dataclasses.dataclass(frozen=True)
class BlockEll:
    vals: np.ndarray    # (n_rb, K, ROW_BLOCK, COL_BLOCK) f32
    colblocks: np.ndarray  # (n_rb, K) int32 — column-block index
    counts: np.ndarray  # (n_rb,) int32 — occupied column blocks
    rows: int
    n_cols: int

    @property
    def n_row_blocks(self) -> int:
        return self.vals.shape[0]

    @property
    def k_max(self) -> int:
        return self.vals.shape[1]

    def padding_ratio(self) -> float:
        dense_elems = self.counts.sum() * ROW_BLOCK * COL_BLOCK
        nnz = np.count_nonzero(self.vals)
        return float(nnz) / max(dense_elems, 1)


def to_block_ell(p: SpmmProblem, *, k_cap: int = 0) -> BlockEll:
    """Host-side packing (part of the benchmark's data pipeline).

    ``k_cap`` bounds column blocks per row block (the ACC chunk-capacity
    knob); overflowing blocks are DROPPED here — the hybrid executor routes
    such rows to the gather path instead, ENEAC-style.  Each row block
    keeps its occupied column blocks in ascending order, the first ``K``
    of them.  Values are accumulated with ``np.add.at`` in the order of the
    reference's loop over rows and their nonzeros.
    """
    R = p.rows
    rpad = (ROW_BLOCK - R % ROW_BLOCK) % ROW_BLOCK
    n_rb = (R + rpad) // ROW_BLOCK
    n_cb = (p.n_cols + COL_BLOCK - 1) // COL_BLOCK
    cpad_cols = n_cb * COL_BLOCK

    # every stored nonzero, in row-major (loop) order
    r, j = np.nonzero(np.arange(p.vals.shape[1]) < p.nnz[:, None].astype(np.int64))
    c = p.cols[r, j].astype(np.int64)
    v = p.vals[r, j]
    rb, ri = np.divmod(r, ROW_BLOCK)
    cb, ci = np.divmod(c, COL_BLOCK)

    # occupied (row block, column block) pairs, sorted by row block then column block
    pair = rb * n_cb + cb
    occupied, which = np.unique(pair, return_inverse=True)
    occ_rb = occupied // n_cb
    per_rb = np.bincount(occ_rb, minlength=n_rb)
    first = np.concatenate([[0], np.cumsum(per_rb)[:-1]])
    rank = np.arange(len(occupied)) - first[occ_rb]  # k of each pair in its row block

    K = int(per_rb.max(initial=0)) or 1
    if k_cap:
        K = min(K, k_cap)
    vals = np.zeros((n_rb, K, ROW_BLOCK, COL_BLOCK), np.float32)
    colblocks = np.zeros((n_rb, K), np.int32)
    counts = np.minimum(per_rb, K).astype(np.int32)
    kept = rank < K
    colblocks[occ_rb[kept], rank[kept]] = (occupied[kept] % n_cb).astype(np.int32)
    k = rank[which]
    keep = k < K
    np.add.at(vals, (rb[keep], k[keep], ri[keep], ci[keep]), v[keep])
    return BlockEll(vals=vals, colblocks=colblocks, counts=counts,
                    rows=R, n_cols=cpad_cols)

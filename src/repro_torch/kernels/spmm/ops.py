"""SPMM execution paths + the ENEAC hybrid executor wiring.

The counterpart of ``repro.kernels.spmm.ops``.  Paths (Table-1 columns):

* ``cc``  — ELL gather path (plain PyTorch on host cores).
* ``acc`` — block-ELL kernel K3 on the card (RHS resident in L2).
* hybrid — MultiDynamic split: densest row-prefix on the ACC path, sparse
  tail on the CC path (rows pre-sorted by density; the split point is the
  scheduler's decision, see
  :class:`repro_torch.core.parallel_for.HybridExecutor`).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ...core.parallel_for import HybridExecutor
from .ref import COL_BLOCK, ROW_BLOCK, SpmmProblem, spmm_ell_ref, to_block_ell
from .spmm import BlockEllArrays, spmm_block_ell

__all__ = ["spmm_cc", "spmm_acc", "density_order", "pad_rhs", "make_hybrid_executor"]


def spmm_cc(vals: torch.Tensor, cols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return spmm_ell_ref(vals, cols, rhs)


def spmm_acc(ell: BlockEllArrays, rhs_padded: torch.Tensor) -> torch.Tensor:
    return spmm_block_ell(ell, rhs_padded)


def density_order(p: SpmmProblem) -> np.ndarray:
    """Row order, densest first — prefix split ⇒ ACC gets the dense rows."""
    return np.argsort(-p.nnz, kind="stable")


def pad_rhs(p: SpmmProblem) -> np.ndarray:
    c_pad = ((p.n_cols + COL_BLOCK - 1) // COL_BLOCK) * COL_BLOCK
    n = p.rhs.shape[1]
    n_pad = ((n + 127) // 128) * 128
    out = np.zeros((c_pad, n_pad), np.float32)
    out[: p.n_cols, :n] = p.rhs
    return out


def make_hybrid_executor(
    p: SpmmProblem,
    *,
    mode: str = "parallel",
    dense_quantum: int = ROW_BLOCK,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[HybridExecutor, np.ndarray]:
    """Build the two path callables over the density-sorted row space.

    The dense path runs K3 on ``device`` and waits for it (the reference's
    ``block_until_ready``); the sparse path gathers on host cores; the
    merged result lies on ``device``.  Returns (executor, row_order);
    ``executor.run()`` gives the full product in sorted-row order (invert
    with row_order).
    """
    device = torch.device(device)
    order = density_order(p)
    sorted_problem = SpmmProblem(
        vals=p.vals[order], cols=p.cols[order], nnz=p.nnz[order],
        n_cols=p.n_cols, rhs=p.rhs,
    )
    vals_s = torch.from_numpy(sorted_problem.vals)
    cols_s = torch.from_numpy(sorted_problem.cols)
    rhs = torch.from_numpy(p.rhs)
    rhs_pad = torch.from_numpy(pad_rhs(p)).to(device)
    n = p.rhs.shape[1]
    R = p.rows

    # packed once at full size; each split slices its leading row blocks
    ell = BlockEllArrays(to_block_ell(sorted_problem), device)

    def dense_fn(n_rows: int):
        if n_rows <= 0:
            return None
        out = spmm_acc(ell.row_blocks(n_rows), rhs_pad)[:n_rows, :n]
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    def sparse_fn(n_rows: int):
        if n_rows <= 0:
            return None
        return spmm_cc(vals_s[R - n_rows:], cols_s[R - n_rows:], rhs)

    def merge_fn(dense_res, sparse_res):
        parts = [r.to(device) for r in (dense_res, sparse_res) if r is not None]
        return torch.cat(parts, dim=0)

    execr = HybridExecutor(
        dense_fn, sparse_fn, merge_fn, num_items=R, mode=mode,
        dense_quantum=dense_quantum,
    )
    return execr, order

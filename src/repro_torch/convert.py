"""State carried across from the reference package.

This system has no weights; its data stands in for them.  The functions
here take the reference package's data as numpy arrays (the fields of an
``SpmmProblem`` or ``BlockEll``, temperature and power grids) and return
the port's tensors on a given device, and back.  They read fields by name,
so the reference's dataclasses and the port's own copies both work.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from .kernels.spmm.ref import BlockEll
from .kernels.spmm.spmm import BlockEllArrays

__all__ = ["to_tensor", "spmm_problem_tensors", "block_ell_tensors",
           "block_ell_numpy", "hotspot_grids"]

Device = Union[str, torch.device]


def to_tensor(a: np.ndarray, device: Device = "cuda") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype and shape on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def spmm_problem_tensors(p, device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """An ``SpmmProblem``'s ELL arrays and dense RHS as tensors."""
    return {name: to_tensor(getattr(p, name), device)
            for name in ("vals", "cols", "nnz", "rhs")}


def block_ell_tensors(be, device: Device = "cuda") -> BlockEllArrays:
    """A ``BlockEll`` as the port's device arrays, ready for K3."""
    return BlockEllArrays(be, device)


def block_ell_numpy(arrays: BlockEllArrays) -> BlockEll:
    """The port's device arrays back as a host ``BlockEll``."""
    return BlockEll(
        vals=arrays.vals.cpu().numpy(), colblocks=arrays.colblocks.cpu().numpy(),
        counts=arrays.counts.cpu().numpy(), rows=arrays.rows, n_cols=arrays.n_cols,
    )


def hotspot_grids(
    temp: np.ndarray, power: np.ndarray, device: Device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature and power grids as float32 tensors."""
    return (to_tensor(np.asarray(temp, np.float32), device),
            to_tensor(np.asarray(power, np.float32), device))

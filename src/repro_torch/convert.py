"""State carried across from the reference package.

The functions here take the reference package's data as numpy arrays and
return the port's tensors on a given device, and back: the paper's
benchmark data (the fields of an ``SpmmProblem`` or ``BlockEll``,
temperature and power grids, read by name, so the reference's dataclasses
and the port's own copies both work) and a model's parameter tree
(:func:`model_params_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .configs.base import ModelConfig
from .kernels.spmm.ref import BlockEll
from .kernels.spmm.spmm import BlockEllArrays
from .models.transformer import pattern_of

__all__ = ["to_tensor", "spmm_problem_tensors", "block_ell_tensors",
           "block_ell_numpy", "hotspot_grids", "model_params_from_jax"]

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


def _param_tensor(a, device: Device) -> torch.Tensor:
    """One parameter as a tensor of its own dtype.  numpy has no bfloat16
    (``ml_dtypes`` adds one that ``torch.from_numpy`` rejects), so every
    array goes through float32, which holds bf16 and f32 values exactly."""
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.from_numpy(
        np.zeros(0, a.dtype)).dtype
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


def _tree(tree, device: Device, index=None):
    if isinstance(tree, dict):
        return {k: _tree(v, device, index) for k, v in tree.items()}
    return _param_tensor(tree if index is None else np.asarray(tree)[index], device)


def model_params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                          device: Device = "cuda") -> Dict[str, Any]:
    """The reference model's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's parameters.

    The reference stacks each pattern position's parameters on a leading
    layer dim (``blocks``) and unrolls the ``remainder``; the port keeps
    one dict per layer in layer order.  ``embed``, ``final_norm`` and
    ``lm_head`` (absent with tied embeddings) carry over as they are.
    """
    pat, repeats, rem = pattern_of(cfg)
    layers = [_tree(tree["blocks"][j], device, r) for r in range(repeats)
              for j in range(len(pat))]
    layers += [_tree(tree["remainder"][j], device) for j in range(len(rem))]
    params = {"embed": _param_tensor(tree["embed"], device), "layers": layers,
              "final_norm": _param_tensor(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _param_tensor(tree["lm_head"], device)
    return params

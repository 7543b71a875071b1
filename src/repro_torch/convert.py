"""State carried across from the reference package.

The functions here take the reference package's data as numpy arrays and
return the port's tensors on a given device, and back: the paper's
benchmark data (the fields of an ``SpmmProblem`` or ``BlockEll``,
temperature and power grids, read by name, so the reference's dataclasses
and the port's own copies both work), a model's parameter tree
(:func:`model_params_from_jax`) and an AdamW state over it
(:func:`adamw_state_from_jax`), so that both packages can start from the
same mid-training state, and a model's serving caches
(:func:`caches_from_jax`), so that both can decode from the same state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import dataclasses

import numpy as np
import torch

from .configs.base import ModelConfig
from .kernels.spmm.ref import BlockEll
from .kernels.spmm.spmm import BlockEllArrays
from .models.attention import KVCache
from .models.rglru import RGLRUState
from .models.ssm import SSMState
from .models.transformer import layer_kinds, pattern_of
from .optim.adamw import AdamWState

__all__ = ["to_tensor", "spmm_problem_tensors", "block_ell_tensors",
           "block_ell_numpy", "hotspot_grids", "model_params_from_jax", "adamw_state_from_jax",
           "caches_from_jax"]

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
    ``lm_head`` (absent with tied embeddings) carry over as they are.  An
    ``encdec`` tree's ``enc_blocks`` and ``dec_blocks`` (stacked over
    ``encoder_layers`` and ``num_layers``) become per-layer lists beside
    ``embed``, ``dec_pos``, ``enc_ln_out`` and ``dec_ln_out``.
    """
    if cfg.family == "encdec":
        return {
            "embed": _param_tensor(tree["embed"], device),
            "dec_pos": _param_tensor(tree["dec_pos"], device),
            "enc_blocks": [_tree(tree["enc_blocks"], device, i)
                           for i in range(cfg.encoder_layers)],
            "enc_ln_out": _tree(tree["enc_ln_out"], device),
            "dec_blocks": [_tree(tree["dec_blocks"], device, i) for i in range(cfg.num_layers)],
            "dec_ln_out": _tree(tree["dec_ln_out"], device),
        }
    pat, repeats, rem = pattern_of(cfg)
    layers = [_tree(tree["blocks"][j], device, r) for r in range(repeats)
              for j in range(len(pat))]
    layers += [_tree(tree["remainder"][j], device) for j in range(len(rem))]
    params = {"embed": _param_tensor(tree["embed"], device), "layers": layers,
              "final_norm": _param_tensor(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _param_tensor(tree["lm_head"], device)
    return params


def adamw_state_from_jax(state, cfg: ModelConfig, device: Device = "cuda") -> AdamWState:
    """The reference's ``AdamWState`` (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's: ``mu`` and ``nu``
    in the port's parameter layout (as :func:`model_params_from_jax`, each
    moment in its own dtype), ``step`` an int32 0-dim tensor on the CPU."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        mu=model_params_from_jax(state.mu, cfg, device),
        nu=model_params_from_jax(state.nu, cfg, device),
    )


_CACHE_TYPES = {"attn": KVCache, "moe": KVCache, "ssd": SSMState, "rglru": RGLRUState}


def _cache(tree, kind: str, device: Device, index=None):
    """One layer's cache of block ``kind`` from the reference's (a
    NamedTuple, or a dict of its fields; ``index``: its layer of a stack)."""
    if kind == "cross":
        return {part: _cache(tree[part], "attn", device, index) for part in ("self", "cross")}
    cls = _CACHE_TYPES[kind]

    def field(name):
        a = tree[name] if isinstance(tree, dict) else getattr(tree, name)
        return _param_tensor(a if index is None else np.asarray(a)[index], device)

    return cls(**{f.name: field(f.name) for f in dataclasses.fields(cls)})


def caches_from_jax(tree, cfg: ModelConfig, device: Device = "cuda") -> List[Any]:
    """The reference model's serving caches (leaves as numpy arrays, each
    cache a NamedTuple or a dict of its fields) as the port's list of one
    cache per layer, in layer order.  The reference stacks each pattern
    position's caches (``{"blocks", "remainder"}``, as its parameters), and
    an ``encdec`` model's ``{"self", "cross"}`` over its decoder layers."""
    if cfg.family == "encdec":
        return [_cache(tree, "cross", device, i) for i in range(cfg.num_layers)]
    pat, repeats, rem = pattern_of(cfg)
    kinds = layer_kinds(cfg)
    caches = [_cache(tree["blocks"][i % len(pat)], kinds[i], device, i // len(pat))
              for i in range(repeats * len(pat))]
    return caches + [_cache(tree["remainder"][j], kind, device) for j, kind in enumerate(rem)]

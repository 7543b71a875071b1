"""Elastic restore: load a checkpoint onto a *different* mesh.

The port's copy of ``repro.checkpoint.elastic_restore``.  A checkpoint
holds full (unsharded) host arrays, so restoring onto any mesh is: resolve
each leaf's layout from the same logical rules and keep this rank's
block of it (:func:`reshard_tree`).  A change of data-parallel degree
also rescales the data-shard count and, linearly, the learning rate
(:func:`elastic_restore_summary`).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..core.elastic import RescalePlan
from ..parallel.mesh_rules import MeshRules, is_axes

__all__ = ["reshard_tree", "elastic_restore_summary"]


def reshard_tree(host_tree, specs_tree, rules: MeshRules, *,
                 device: Union[str, torch.device] = "cuda"):
    """This rank's shard of every full host array (numpy or tensor) of
    ``host_tree``, laid out by the rules' resolution of the logical axes
    in ``specs_tree``, as a contiguous tensor on ``device``."""
    coords = rules.coordinate()

    def one(arr, axes):
        t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
        index = rules.local_slice(rules.spec(axes, tuple(t.shape)), tuple(t.shape), coords)
        return t[index].to(device).contiguous()

    return _zip_map(one, host_tree, specs_tree)


def _zip_map(fn, tree, specs):
    if is_axes(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _zip_map(fn, tree[k], v) for k, v in specs.items()}
    return type(specs)(_zip_map(fn, tree[i], v) for i, v in enumerate(specs))


def elastic_restore_summary(plan: RescalePlan, *, old_lr: float) -> Dict[str, Any]:
    """Bookkeeping deltas after a rescale: linear-scaled LR and the new
    data-shard count (the stateless data pipeline keys on these)."""
    return {
        "new_mesh_shape": plan.new_shape,
        "dp_scale": plan.dp_scale,
        "new_lr": old_lr * plan.dp_scale,
        "lost_devices": list(plan.lost_devices),
        "needs_reshard": plan.needs_reshard,
    }

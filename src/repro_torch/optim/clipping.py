"""Global-norm gradient clipping (fp32 accumulation).

The port's copy of ``repro.optim.clipping``, over the port's trees.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *, norm: Optional[torch.Tensor] = None,
                        inplace: bool = False):
    """(``tree`` scaled to a global norm of at most ``max_norm``, the norm
    before).  ``norm`` is the tree's norm where the tree holds only this
    rank's shards of it (computed over the mesh by the caller).
    ``inplace=True`` writes the scaled values into ``tree``'s tensors (the
    same values) and returns it."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if inplace:
        return tree_map(lambda x: x.copy_((x.float() * scale).to(x.dtype)), tree), norm
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm

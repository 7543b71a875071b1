"""The reference's training steps: float32 gradients, global-norm clipping
and AdamW, from the same weights and batches as the program's first steps.

Each step's rows are cut into the traffic's ``microbatches`` as the
program's step cuts them (equal pieces, in order), and the family's
``microbatch_loss`` (``families/<family>.py``) takes each piece whole:
a family whose loss is not a sum over rows (experts' capacity, terms
averaged over a microbatch) sees what the program's step sees.  A family
whose loss is such a sum gives its ``layer`` instead, and each piece is
taken in blocks of rows (``model.blocked_loss``).

The configuration states the parameters' dtype (``param_dtype``): they are
held in it, as the program holds them, so each update is rounded into
it; every other number is float32.  The arithmetic is the configuration's
and the traffic's, written out here: the loss is the mean token NLL over
the step's rows, with any term the family's loss adds; the gradient is clipped to a global norm of
``grad_clip``; AdamW (``b1``, ``b2``, ``eps``, bias-corrected moments)
adds ``weight_decay`` × the parameter to the update of every leaf but
those the configuration names in ``no_decay``, and the parameter takes
−lr × the update.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from .. import families
from ..inputs import tree_of
from .model import blocked_loss

__all__ = ["reference_steps"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return torch.stack([t.float().norm() for t in tensors]).tolist()


def reference_steps(leaves: List[Tuple[tuple, torch.Tensor]],
                    batches: List[Tuple[torch.Tensor, torch.Tensor]], m: Dict, t: Dict,
                    mm, rows_per_block: int) -> Dict:
    """Train ``len(batches)`` steps from ``leaves`` ([(path, float32 tensor)]
    holding the starting weights; updated in place) -> {"losses": per
    step, "grads": per-leaf norms of the first step's clipped gradient,
    "raw_grads": the same before clipping, "changes": per-leaf norms of the
    weights' change after the last step}, each per-leaf list in the
    leaves' order."""
    store = DTYPES[m["param_dtype"]]
    family = families.load(m["family"])
    microbatch_loss = (getattr(family, "microbatch_loss", None)
                       or functools.partial(blocked_loss, layer=family.layer))
    pieces = t["microbatches"]
    opt = t["adamw"]
    b1, b2, eps, wd, lr = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], t["lr"]
    no_decay = {tuple(p) for p in m["no_decay"]}
    paths = [p for p, _ in leaves]
    params = [x.detach().requires_grad_(True) for _, x in leaves]
    start = [x.detach().to(store, copy=True) for x in params]
    tree = tree_of(list(zip(paths, params)))
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    out: Dict = {"losses": []}
    for step, (tokens, labels) in enumerate(batches, start=1):
        count, size = tokens.numel(), tokens.shape[0] // pieces
        total = 0.0
        for lo in range(0, pieces * size, size):
            total += microbatch_loss(tree, tokens[lo:lo + size], labels[lo:lo + size], m, t, mm,
                                     rows_per_block, count)
        out["losses"].append(total)
        with torch.no_grad():
            grads = [x.grad for x in params]
            norm = math.sqrt(sum(n * n for n in _norms(grads)))
            scale = min(1.0, t["grad_clip"] / max(norm, 1e-12))
            if step == 1:
                out["raw_grads"] = _norms(grads)
            for g in grads:
                g.mul_(scale)
            if step == 1:
                out["grads"] = _norms(grads)
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for path, x, g, mo, ve in zip(paths, params, grads, mu, nu):
                mo.mul_(b1).add_(g, alpha=1 - b1)
                ve.mul_(b2).add_(g * g, alpha=1 - b2)
                u = (mo / c1) / (torch.sqrt(ve / c2) + eps)
                if wd and path not in no_decay:
                    u = u + wd * x
                x.copy_((x - lr * u).to(store).float())
                x.grad = None
    with torch.no_grad():
        out["changes"] = _norms([x.to(store).float() - s.float() for x, s in zip(params, start)])
    return out


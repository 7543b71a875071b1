"""The training step: forward, backward, clip, AdamW, apply.

The port's copy of ``repro.launch.steps``'s training half, on one card
(no mesh and no shardings until slice F; ``make_decode_step`` and
``make_prefill_step``, which exist to give the dry-run a function to
lower, wait for it too).  :func:`make_train_step` returns a
:class:`TrainStep`, a callable ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` that works as the reference's: the batch is cut
into ``microbatches`` contiguous pieces (the ENEAC iteration space), each
piece's gradient is added as ``g / mb`` in ``grad_accum_dtype`` and its
metrics likewise, then the gradients are clipped to a global norm of
``GRAD_CLIP`` and AdamW updates the parameters.  The gradients are
autograd's, through K4 and K5's ``Function``s on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..models import Model
from ..optim import AdamW, AdamWState, clip_by_global_norm
from ..tree import tree_leaves, tree_map

__all__ = ["GRAD_CLIP", "TrainStep", "default_microbatches", "make_train_step"]

GRAD_CLIP = 1.0


def default_microbatches(cfg: ModelConfig, shape: InputShape, *, dp: int = 1,
                         target_tokens_per_device: int = 8192) -> int:
    """Pick the grad-accum count so one microbatch's activations fit the card.

    The microbatches ARE the ENEAC iteration space; ``dp`` is the number
    of data-parallel groups (1 until slice F's mesh).
    """
    if cfg.parallel.microbatches > 1:
        return cfg.parallel.microbatches
    tokens_per_device = shape.global_batch * shape.seq_len // dp
    mb = max(1, tokens_per_device // target_tokens_per_device)
    # microbatch must divide the per-DP-group batch
    per_group = max(1, shape.global_batch // dp)
    while per_group % mb and mb > 1:
        mb -= 1
    return mb


class TrainStep:
    """One training step of ``model`` with ``optimizer`` at a fixed ``lr``."""

    def __init__(self, model: Model, optimizer: AdamW, *, lr: float, loss_chunk: int,
                 microbatches: int) -> None:
        self.model = model
        self.optimizer = optimizer
        self.lr = lr
        self.loss_chunk = loss_chunk
        self.microbatches = microbatches

    def _value_and_grad(self, params, batch) -> Tuple[Any, Dict[str, torch.Tensor]]:
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(live)
        loss, metrics = self.model.loss_fn(tree_map(lambda _: next(it), params), batch,
                                           loss_chunk=self.loss_chunk)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        it = iter(grads)
        return (tree_map(lambda _: next(it), params),
                {k: metrics[k].detach() for k in ("loss", "ce_loss")})

    def grads(self, params, batch: Dict[str, torch.Tensor]) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """(gradients, {"loss", "ce_loss"}) of one batch, accumulated over
        the microbatches: the step's work before the optimizer."""
        mb = self.microbatches
        if mb == 1:
            return self._value_and_grad(params, batch)
        acc_dtype = (torch.bfloat16 if self.model.cfg.parallel.grad_accum_dtype == "bfloat16"
                     else torch.float32)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device), params)
        macc = None
        size = next(iter(batch.values())).shape[0] // mb
        for i in range(mb):
            piece = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            grads, metrics = self._value_and_grad(params, piece)
            with torch.no_grad():
                tree_map(lambda a, g: a.add_(g.to(a.dtype) / mb), gacc, grads)
            del grads
            if macc is None:
                macc = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                        for k, v in metrics.items()}
            macc = {k: macc[k] + metrics[k] / mb for k in macc}
        return gacc, macc

    def update(self, params, opt_state: AdamWState, grads, metrics: Dict[str, torch.Tensor]):
        """The step's work after the gradients: clip to ``GRAD_CLIP``, AdamW,
        apply -> (params, opt_state, metrics with ``grad_norm``, the norm
        before clipping)."""
        grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP)
        updates, opt_state = self.optimizer.update(grads, opt_state, params, self.lr)
        del grads
        params = AdamW.apply_updates(params, updates)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    def __call__(self, params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        return self.update(params, opt_state, *self.grads(params, batch))


def make_train_step(model: Model, optimizer: AdamW, shape: InputShape, *, lr: float = 3e-4,
                    loss_chunk: int = 1024, microbatches: Optional[int] = None) -> TrainStep:
    """The training step for batches of ``shape``; ``microbatches`` (default
    :func:`default_microbatches`) falls to the largest count that divides
    the batch."""
    mb = microbatches if microbatches is not None else default_microbatches(model.cfg, shape)
    while mb > 1 and shape.global_batch % mb:
        mb -= 1
    return TrainStep(model, optimizer, lr=lr, loss_chunk=loss_chunk, microbatches=mb)

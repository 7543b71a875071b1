"""The training step: forward, backward, clip, AdamW, apply — on a mesh.

The port's copy of ``repro.launch.steps``'s training half.
:func:`make_train_step` returns a :class:`TrainStep`, a callable
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that works
as the reference's: the global batch is cut into ``microbatches``
contiguous pieces (the ENEAC iteration space), each piece's gradient is
added in ``grad_accum_dtype`` and its metrics likewise, then the
gradients are clipped to a global norm of ``GRAD_CLIP`` and AdamW updates
the parameters.  The gradients are autograd's, through K4 and K5's
``Function``s on the card.

**On a mesh** (``MeshRules``; data axes ``pod`` × ``data`` of ``dp``
ranks, a ``model`` axis of 1) the step is FSDP done by hand, the work
GSPMD derives for the reference's shardings there:

* each rank holds the parameter and AdamW-moment shards that the rules
  give (:meth:`TrainStep.shard`; the moments mirror the parameters);
* each parameter is all-gathered to a plain tensor before the forward,
  so K4 and K5 only ever see plain, contiguous tensors;
* each rank takes its rows of every microbatch of the global batch
  (:func:`batch_shardings`) and runs them through the microbatch loop;
  its gradients are weighted by its share of each microbatch's mask sum,
  so the loss is the reference's mean over the global microbatch;
* the gradients are reduce-scattered (all-reduced for a replicated
  leaf), clipped by the global norm summed over the mesh, and AdamW
  updates the shards.

With ``dp`` 1 no collective runs, and the step is the one-card step
unchanged.  A ``model`` axis larger than 1 (tensor and sequence
parallelism) waits for slice F2, as does the ``moe`` family on a mesh
(its aux losses are not per-token means; ``_moe_ffn_local`` is F2's).
``make_decode_step`` and ``make_prefill_step``, which give the dry-run a
function to lower, wait for slice F3.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..checkpoint.elastic_restore import reshard_tree
from ..configs.base import InputShape, ModelConfig
from ..models import Model
from ..optim import AdamW, AdamWState, clip_by_global_norm
from ..parallel.collectives import Group
from ..parallel.mesh_rules import MeshRules, Spec, axes_leaves
from ..tree import tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path

__all__ = ["GRAD_CLIP", "TrainStep", "batch_shardings", "data_parallel_size",
           "default_microbatches", "make_train_step"]

GRAD_CLIP = 1.0
DATA_AXES = ("pod", "data")


def _batch_specs(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    specs = {}
    if kind == "train":
        specs = {"tokens": ("act_batch", None), "labels": ("act_batch", None),
                 "mask": ("act_batch", None)}
    elif kind == "prefill":
        specs = {"tokens": ("act_batch", None)}
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        specs["frames"] = ("act_batch", None, "act_embed")
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        specs["image_embeds"] = ("act_batch", None, "act_embed")
    return specs


def batch_shardings(model: Model, shape: InputShape, rules: MeshRules) -> Dict[str, Spec]:
    """{batch key: spec} of an input batch of ``shape`` (the specs of the
    reference's ``NamedSharding``s)."""
    if shape.kind not in ("train", "prefill"):
        raise ValueError("decode shardings wait for make_decode_step (slice F3)")
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    dims = {"tokens": (b, s), "labels": (b, s), "mask": (b, s),
            "frames": (b, cfg.encoder_seq, cfg.d_model),
            "image_embeds": (b, cfg.num_image_tokens, cfg.d_model)}
    return {k: rules.spec(axes, dims[k]) for k, axes in _batch_specs(cfg, shape.kind).items()}


def data_parallel_size(rules: MeshRules) -> int:
    """The number of data-parallel groups: the mesh's ``pod`` × ``data``."""
    return math.prod(rules.axis_sizes.get(ax, 1) for ax in DATA_AXES)


def default_microbatches(cfg: ModelConfig, shape: InputShape, rules: MeshRules,
                         *, target_tokens_per_device: int = 8192) -> int:
    """Pick the grad-accum count so one microbatch's activations fit the card.

    The microbatches ARE the ENEAC iteration space; ``dp`` comes from the
    mesh.
    """
    if cfg.parallel.microbatches > 1:
        return cfg.parallel.microbatches
    dp = data_parallel_size(rules)
    tokens_per_device = shape.global_batch * shape.seq_len // dp
    mb = max(1, tokens_per_device // target_tokens_per_device)
    # microbatch must divide the per-DP-group batch
    per_group = max(1, shape.global_batch // dp)
    while per_group % mb and mb > 1:
        mb -= 1
    return mb


class _Leaf:
    """One parameter's layout over the data-parallel group: its full shape,
    every group rank's index of it (``None``: every rank holds it whole),
    and whether this rank counts it in the global norm (the first rank that
    holds its block does)."""

    def __init__(self, shape: Tuple[int, ...], spec: Spec, rules: MeshRules,
                 coords: List[Dict[str, int]], rank: int) -> None:
        self.shape = shape
        slices = [rules.local_slice(spec, shape, c) for c in coords]
        self.slices = None if all(sl == slices[0] for sl in slices) else slices
        self.counted = slices.index(slices[rank]) == rank


class TrainStep:
    """One training step of ``model`` with ``optimizer`` at a fixed ``lr``
    on the mesh of ``rules``."""

    def __init__(self, model: Model, optimizer: AdamW, rules: MeshRules, *, lr: float,
                 loss_chunk: int, microbatches: int) -> None:
        self.model = model
        self.optimizer = optimizer
        self.rules = rules
        self.lr = lr
        self.loss_chunk = loss_chunk
        self.microbatches = microbatches
        self.dp = data_parallel_size(rules)
        if rules.axis_sizes.get("model", 1) > 1:
            raise NotImplementedError("a model axis larger than 1 (tensor and sequence "
                                      "parallelism) waits for slice F2")
        if self.dp == 1:
            return
        if model.cfg.family == "moe":
            raise NotImplementedError("the moe family on a data-parallel mesh (its aux "
                                      "losses, _moe_ffn_local) waits for slice F2")
        mesh = rules.mesh
        self.group = Group()
        if not hasattr(mesh, "mesh") or self.group.size != self.dp:
            raise ValueError(f"a mesh of {self.dp} ranks is a DeviceMesh over a process group "
                             f"of {self.dp} (launch.mesh.make_mesh)")
        # every group rank's coordinate: the process group is the mesh's ranks
        coords = [dict(zip(mesh.mesh_dim_names, (mesh.mesh == k).nonzero()[0].tolist()))
                  for k in range(self.dp)]
        self.param_axes = model.param_specs()
        self.layout = {path: _Leaf(tuple(a.shape), rules.spec(axes, tuple(a.shape)), rules,
                                   coords, self.group.rank)
                       for axes, (path, a) in zip(axes_leaves(self.param_axes),
                                                  tree_leaves_with_path(model.abstract_params()))}

    # -- layouts ----------------------------------------------------------
    def shard(self, tree):
        """This rank's shards of a full tree laid out like the parameters
        (parameters, gradients, AdamW moments); the tree itself at dp 1."""
        if self.dp == 1:
            return tree
        return reshard_tree(tree, self.param_axes, self.rules, device=self.model.device)

    def gather(self, shards):
        """The full tree of a tree of this rank's shards (a collective: every
        rank calls it); the tree itself at dp 1."""
        if self.dp == 1:
            return shards

        def one(path, t):
            leaf = self.layout[path]
            if leaf.slices is None:
                return t
            parts = self.group.all_gather(t)
            full = torch.empty(leaf.shape, dtype=t.dtype, device=t.device)
            for sl, part in zip(leaf.slices, parts):
                full[sl] = part
            return full

        return tree_map_with_path(one, shards)

    def local_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of each microbatch of the global ``batch``, the
        microbatches in order."""
        rows, seq = batch["tokens"].shape
        per = rows // self.microbatches
        specs = batch_shardings(self.model, InputShape("microbatch", seq, per, "train"),
                                self.rules)
        return {k: torch.cat([piece[self.rules.local_slice(specs[k], piece.shape)]
                              for piece in v.split(per)])
                for k, v in batch.items()}

    # -- the step -----------------------------------------------------------
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

    def _accumulate(self, params, batch, weights=None):
        """(gradients, metrics) of ``batch`` in ``microbatches`` pieces: the
        mean of the pieces' (one card), or their sum weighted by ``weights``
        (one per piece, on a mesh)."""
        mb = self.microbatches
        if mb == 1 and weights is None:
            return self._value_and_grad(params, batch)
        acc_dtype = (torch.bfloat16 if self.model.cfg.parallel.grad_accum_dtype == "bfloat16"
                     else torch.float32)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device), params)
        macc = None
        size = next(iter(batch.values())).shape[0] // mb
        for i in range(mb):
            piece = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            grads, metrics = self._value_and_grad(params, piece)
            weigh = (lambda x: x / mb) if weights is None else (lambda x, w=weights[i]: x * w)
            with torch.no_grad():
                tree_map(lambda a, g: a.add_(weigh(g.to(a.dtype))), gacc, grads)
            del grads
            if macc is None:
                macc = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                        for k, v in metrics.items()}
            macc = {k: macc[k] + weigh(metrics[k]) for k in macc}
        return gacc, macc

    def _weights(self, local: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Each piece's weight: this rank's mask sum in the microbatch over
        the microbatch's mask sum on the mesh (at least 1), over the count."""
        mb = self.microbatches
        labels = local["labels"]
        mask = local["mask"].float() if "mask" in local else torch.ones(
            labels.shape, dtype=torch.float32, device=labels.device)
        mine = mask.reshape(mb, -1).sum(dim=1)
        total = self.group.all_reduce(mine.clone())
        return mine / torch.clamp(total, min=1.0) / mb

    def grads(self, params, batch: Dict[str, torch.Tensor]) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """(gradients, {"loss", "ce_loss"}) of one global batch, accumulated
        over the microbatches: the step's work before the optimizer.  On a
        mesh ``params`` and the gradients are this rank's shards, and the
        metrics the global batch's."""
        if self.dp == 1:
            return self._accumulate(params, batch)
        local = self.local_batch(batch)
        full = self.gather(params)
        gacc, macc = self._accumulate(full, local, self._weights(local))
        del full

        def reduce(path, g):
            leaf = self.layout[path]
            if leaf.slices is None:
                return self.group.all_reduce(g)
            return self.group.reduce_scatter(torch.stack([g[sl] for sl in leaf.slices]))

        grads = tree_map_with_path(reduce, gacc)
        del gacc
        keys = list(macc)
        summed = self.group.all_reduce(torch.stack([macc[k] for k in keys]))
        return grads, dict(zip(keys, summed.unbind()))

    def _global_norm(self, grads) -> torch.Tensor:
        """The gradients' norm over the mesh: each block's squares counted
        once, by the first rank that holds it."""
        sq = torch.stack([torch.sum(torch.square(g.float())) if self.layout[path].counted
                          else torch.zeros((), device=g.device)
                          for path, g in tree_leaves_with_path(grads)])
        return torch.sqrt(sum(self.group.all_reduce(sq).unbind()))

    def update(self, params, opt_state: AdamWState, grads, metrics: Dict[str, torch.Tensor]):
        """The step's work after the gradients: clip to ``GRAD_CLIP``, AdamW,
        apply -> (params, opt_state, metrics with ``grad_norm``, the norm
        before clipping).  On a mesh every tree holds this rank's shards."""
        norm = None if self.dp == 1 else self._global_norm(grads)
        grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP, norm=norm)
        updates, opt_state = self.optimizer.update(grads, opt_state, params, self.lr)
        del grads
        params = AdamW.apply_updates(params, updates)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    def __call__(self, params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        return self.update(params, opt_state, *self.grads(params, batch))


def make_train_step(model: Model, optimizer: AdamW, rules: MeshRules, shape: InputShape, *,
                    lr: float = 3e-4, loss_chunk: int = 1024,
                    microbatches: Optional[int] = None) -> TrainStep:
    """The training step for global batches of ``shape`` on the mesh of
    ``rules``; ``microbatches`` (default :func:`default_microbatches`)
    falls to the largest count whose microbatch still splits over the
    data-parallel ranks."""
    mb = (microbatches if microbatches is not None
          else default_microbatches(model.cfg, shape, rules))
    dp = data_parallel_size(rules)
    if shape.global_batch % dp:
        raise ValueError(f"a global batch of {shape.global_batch} does not split over "
                         f"{dp} data-parallel ranks")
    while mb > 1 and (shape.global_batch % mb or (shape.global_batch // mb) % dp):
        mb -= 1
    return TrainStep(model, optimizer, rules, lr=lr, loss_chunk=loss_chunk, microbatches=mb)

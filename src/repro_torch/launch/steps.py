"""The training and serving steps — on a mesh.

The port's copy of ``repro.launch.steps``.  :func:`make_train_step`
returns a :class:`TrainStep`, a callable
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that works
as the reference's: the global batch is cut into ``microbatches``
contiguous pieces (the ENEAC iteration space), each piece's gradient is
added in ``grad_accum_dtype`` and its metrics likewise, then the
gradients are clipped to a global norm of ``GRAD_CLIP`` and AdamW updates
the parameters.  The gradients are autograd's, through K4 and K5's
``Function``s on the card.

**On a mesh** (``MeshRules`` over a ``DeviceMesh``; data axes ``pod`` ×
``data`` of ``dp`` ranks, a ``model`` axis of ``mp``) the step is FSDP
over the data axes and Megatron's tensor parallelism over ``model``,
done by hand — the work GSPMD derives for the reference's shardings:

* each rank holds the parameter and AdamW-moment blocks that the rules
  give over the whole mesh (:meth:`TrainStep.shard`; the moments mirror
  the parameters);
* each parameter is all-gathered over the data axes only, before the
  forward: the rank keeps its ``model`` block (the models gather the
  few leaves they need whole: cut kv heads, the SSD block's ``in_proj``
  and conv, RG-LRU's ``lru`` leaves where the model size does not
  divide 8).  K4 and K5 see plain, contiguous tensors: the rank's heads;
* the model runs its tensor-parallel forms
  (:class:`~repro_torch.parallel.tensor_parallel.TensorParallel`), whose
  collectives carry the gradients within the model group;
* every rank of a data group takes the same rows of every microbatch of
  the global batch (:func:`batch_shardings`) and runs them through the
  microbatch loop; its loss is weighted by its share of each
  microbatch's mask sum, so the sum over the data ranks is the
  reference's mean over the global microbatch;
* the gradients are reduce-scattered over the data axes (all-reduced for
  a leaf replicated there); under sequence parallelism every leaf the
  rules do not split over ``model`` (the norms, the router, the vision
  model's gates) holds a partial sum over its sequence shard and is
  all-reduced over ``model`` too; the global norm counts each block once
  on the whole mesh, and AdamW updates the blocks;
* the metrics are summed over the data axes only (the model ranks of a
  data group hold the same values).

With a mesh of one rank no collective runs, and the step is the one-card
step unchanged.

**Serving** (slice F3a): :func:`make_prefill_step` and
:func:`make_decode_step` return the reference's serving steps,
``prefill(shards, batch) -> (logits, caches)`` and ``decode(shards,
tokens, positions, caches) -> (logits, caches)``.  They take the rank's
parameter blocks, as :meth:`TrainStep.shard` gives them (a checkpoint of
``run_training`` on a mesh serves unchanged), and each call gathers the
data-axis shards (:meth:`forward_params`), as GSPMD does for the
reference's shardings.  Each rank takes its data shard's rows of the
global ``batch`` / ``tokens`` / ``positions`` and runs the models'
tensor-parallel serving forms: its caches are its rows and what its
model rank computes with, and its logits are its rows of its block of the
vocabulary, the reference's ``("act_batch", "act_vocab")`` out-sharding
(``models.greedy_tokens`` takes the argmax over the model group).  On
one rank a step is ``Model.prefill`` / ``decode_step`` unchanged.  The
layout half — the leaves' blocks, ``shard``, ``gather``,
``forward_params``, ``local_batch`` — is one base the three steps share.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import tracing
from ..checkpoint.elastic_restore import reshard_tree
from ..configs.base import InputShape, ModelConfig
from ..models import Model
from ..optim import AdamW, AdamWState, clip_by_global_norm
from ..parallel.collectives import Group
from ..parallel.mesh_rules import DATA_AXES, MeshRules, Spec, axes_leaves
from ..parallel.tensor_parallel import TensorParallel
from ..tree import tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path

__all__ = ["GRAD_CLIP", "TrainStep", "ServeStep", "PrefillStep", "DecodeStep", "batch_shardings",
           "data_parallel_size", "default_microbatches", "make_train_step", "make_prefill_step",
           "make_decode_step"]

GRAD_CLIP = 1.0
# logical axes whose split over ``model`` the models compute on as blocks
# (a parameter naming one must have that dim split there); the rest of the
# split axes (qheads, kvheads, ssm_inner, conv_ch) are gathered where needed
_SPLIT_AXES = ("mlp", "vocab", "lru")


def _batch_specs(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    specs = {}
    if kind == "train":
        specs = {"tokens": ("act_batch", None), "labels": ("act_batch", None),
                 "mask": ("act_batch", None)}
    elif kind == "prefill":
        specs = {"tokens": ("act_batch", None)}
    elif kind == "decode":
        specs = {"tokens": ("act_batch", None), "positions": ("act_batch", None)}
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        specs["frames"] = ("act_batch", None, "act_embed")
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        specs["image_embeds"] = ("act_batch", None, "act_embed")
    return specs


def batch_shardings(model: Model, shape: InputShape, rules: MeshRules) -> Dict[str, Spec]:
    """{batch key: spec} of an input batch of ``shape`` (the specs of the
    reference's ``NamedSharding``s; a decode step's ``tokens`` and
    ``positions``, one column each)."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len if shape.kind != "decode" else 1
    dims = {"tokens": (b, s), "labels": (b, s), "mask": (b, s), "positions": (b, s),
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
    """One parameter's layout: its full shape, its shape in the forward
    (the ``model`` block), every data-group rank's index of that block
    (``data``; ``None``: every data rank holds it whole), every mesh rank's
    index of the full parameter (``mesh``; ``None``: every rank holds it
    whole), whether the rules split it over ``model``, and whether this
    rank counts it in the global norm (the first mesh rank that holds its
    block does)."""

    def __init__(self, shape: Tuple[int, ...], spec: Spec, rules: MeshRules,
                 data_coords: List[Dict[str, int]], mesh_coords: List[Dict[str, int]],
                 rank: int) -> None:
        def names(entry):
            return () if entry is None else (entry,) if isinstance(entry, str) else entry

        model = tuple("model" if "model" in names(e) else None for e in spec)
        data = tuple(None if "model" in names(e) else e for e in spec)
        self.shape = shape
        self.model_split = any(model)
        self.local_shape = tuple(len(range(n)[sl]) for n, sl in
                                 zip(shape, rules.local_slice(model, shape)))
        dslices = [rules.local_slice(data, self.local_shape, c) for c in data_coords]
        self.data = None if all(sl == dslices[0] for sl in dslices) else dslices
        mslices = [rules.local_slice(spec, shape, c) for c in mesh_coords]
        self.mesh = None if all(sl == mslices[0] for sl in mslices) else mslices
        self.counted = mslices.index(mslices[rank]) == rank


def _check_split(path, axes, spec: Spec, mp: int) -> None:
    """Raise unless the rules split over ``model`` the dims the models
    compute on as blocks (an expert's: its expert or its hidden dim)."""
    split = {name for name, entry in zip(axes, spec) if entry == "model"}
    need = [name for name in axes if name in _SPLIT_AXES and name not in split]
    if "experts" in axes and not split & {"experts", "expert_mlp"}:
        need.append("experts")
    if need:
        raise NotImplementedError(f"{'/'.join(map(str, path))}: its {need[0]!r} dim does not "
                                  f"split over {mp} model ranks")


class _MeshStep:
    """The layout half of a step of ``model`` on the mesh of ``rules``: each
    leaf's blocks (``layout``), and the rows of a batch this rank takes."""

    kind = "train"          # the batch's kind (its keys and their specs)
    microbatches = 1

    def __init__(self, model: Model, rules: MeshRules) -> None:
        self.model = model
        self.rules = rules
        self.dp = data_parallel_size(rules)
        self.mp = rules.model_size
        self.tp = None
        if self.dp * self.mp == 1:
            return
        n = self.dp * self.mp
        where = f"a mesh of {n} ranks is a DeviceMesh over a process group of as many " \
                f"(launch.mesh.make_mesh)"
        if rules.shape_only:     # the dry-run: rank 0 of shape-only groups
            if torch.device(model.device).type != "meta":
                raise ValueError(f"{where}, or a MeshShape for a model on meta tensors")
        elif not hasattr(rules.mesh, "mesh") or Group().size != n:
            raise ValueError(where)
        self.world = rules.world_group
        self.group = rules.data_group            # the data axes
        self.tp = TensorParallel(rules)
        if rules.shape_only:
            data_ranks = [k for k, c in enumerate(rules.rank_coordinates(range(n)))
                          if c.get("model", 0) == rules.model_rank]
        elif self.group.size == 1:
            data_ranks = [self.world.rank]
        elif self.group.pg is None:
            data_ranks = list(range(n))
        else:
            data_ranks = dist.get_process_group_ranks(self.group.pg)
        self.param_axes = model.param_specs()
        data_coords = rules.rank_coordinates(data_ranks)
        mesh_coords = rules.rank_coordinates(range(n))
        self.layout = {}
        for axes, (path, a) in zip(axes_leaves(self.param_axes),
                                   tree_leaves_with_path(model.abstract_params())):
            shape = tuple(a.shape)
            spec = rules.spec(axes, shape)
            if self.mp > 1:
                _check_split(path, axes, spec, self.mp)
            self.layout[path] = _Leaf(shape, spec, rules, data_coords, mesh_coords,
                                      self.world.rank)

    # -- layouts ----------------------------------------------------------
    def shard(self, tree):
        """This rank's blocks of a full tree laid out like the parameters
        (parameters, gradients, AdamW moments); the tree itself on one rank."""
        if self.tp is None:
            return tree
        return reshard_tree(tree, self.param_axes, self.rules, device=self.model.device)

    def gather(self, shards):
        """The full tree of a tree of this rank's blocks (a collective: every
        rank of the mesh calls it); the tree itself on one rank."""
        if self.tp is None:
            return shards

        def one(path, t):
            leaf = self.layout[path]
            if leaf.mesh is None:
                return t
            parts = self.world.all_gather(t)
            full = torch.empty(leaf.shape, dtype=t.dtype, device=t.device)
            for sl, part in zip(leaf.mesh, parts):
                full[sl] = part
            return full

        return tree_map_with_path(one, shards)

    def forward_params(self, shards):
        """This rank's ``model`` block of each parameter, what its forward
        computes with: its data-axis shards gathered (a collective over the
        data group)."""
        def one(path, t):
            leaf = self.layout[path]
            if leaf.data is None:
                return t
            parts = self.group.all_gather(t)
            full = torch.empty(leaf.local_shape, dtype=t.dtype, device=t.device)
            for sl, part in zip(leaf.data, parts):
                full[sl] = part
            return full

        return tree_map_with_path(one, shards)

    def local_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of each microbatch of the global ``batch``, the
        microbatches in order (the same rows on every rank of a data group)."""
        rows, seq = batch["tokens"].shape
        per = rows // self.microbatches
        specs = batch_shardings(self.model, InputShape("microbatch", seq, per, self.kind),
                                self.rules)
        return {k: torch.cat([piece[self.rules.local_slice(specs[k], piece.shape)]
                              for piece in v.split(per)])
                for k, v in batch.items()}


class TrainStep(_MeshStep):
    """One training step of ``model`` with ``optimizer`` at a fixed ``lr``
    on the mesh of ``rules``."""

    def __init__(self, model: Model, optimizer: AdamW, rules: MeshRules, *, lr: float,
                 loss_chunk: int, microbatches: int) -> None:
        self.optimizer = optimizer
        self.lr = lr
        self.loss_chunk = loss_chunk
        self.microbatches = microbatches
        super().__init__(model, rules)

    # -- the step -----------------------------------------------------------
    def pieces(self):
        """The microbatches the accumulation runs, in order: their indices
        (the dry-run counts the second for every one after the first)."""
        return range(self.microbatches)

    def _value_and_grad(self, params, batch, weight=None) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """(gradients of the loss, or of ``weight`` × the loss, metrics)."""
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(live)
        loss, metrics = self.model.loss_fn(tree_map(lambda _: next(it), params), batch,
                                           loss_chunk=self.loss_chunk, tp=self.tp)
        if weight is not None:
            loss = loss * weight
        with tracing.span("backward"):
            try:
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            finally:
                tracing.close_backward()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        it = iter(grads)
        return (tree_map(lambda _: next(it), params),
                {k: metrics[k].detach() for k in ("loss", "ce_loss")})

    def _accumulate(self, params, batch, weights=None, reduce=None):
        """(gradients, metrics) of ``batch`` in ``microbatches`` pieces: the
        mean of the pieces' (one card), or their sum weighted by ``weights``
        (one per piece, on a mesh).  On a mesh the weight scales the loss
        before the backward: a gradient crosses the data ranks inside it
        (the MoE aux values' mean, the global plan's gathered tokens), so
        each rank's share must be weighed where it arises.  One piece keeps
        no accumulator.  ``reduce``, when given, takes each piece's
        gradients to this rank's blocks of their sum over the mesh before
        they are added up."""
        mb = self.microbatches
        if mb == 1:
            w = None if weights is None else weights[0]
            grads, metrics = self._value_and_grad(params, batch, w)
            return grads, metrics if w is None else {k: v * w for k, v in metrics.items()}
        acc_dtype = (torch.bfloat16 if self.model.cfg.parallel.grad_accum_dtype == "bfloat16"
                     else torch.float32)
        gacc = macc = None
        size = next(iter(batch.values())).shape[0] // mb
        for i in self.pieces():
            piece = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            weigh = (lambda x: x / mb) if weights is None else (lambda x, w=weights[i]: x * w)
            grads, metrics = self._value_and_grad(params, piece,
                                                  None if weights is None else weights[i])
            if reduce is not None:
                grads = reduce(grads)
            with tracing.span("accumulate"):
                if gacc is None:
                    gacc = tree_map(lambda g: torch.zeros(g.shape, dtype=acc_dtype,
                                                          device=g.device), grads)
                with torch.no_grad():
                    tree_map(lambda a, g: a.add_(g.to(a.dtype) / mb if weights is None
                                                 else g.to(a.dtype)), gacc, grads)
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
        mesh ``params`` and the gradients are this rank's blocks, and the
        metrics the global batch's."""
        if self.tp is None:
            return self._accumulate(params, batch)
        local = self.local_batch(batch)
        full = self.forward_params(params)
        # a bf16 sum rounds each piece: the pieces are summed over the mesh
        # first, in float32, as the reference's step sums them
        each = self.microbatches > 1 and self.model.cfg.parallel.grad_accum_dtype == "bfloat16"
        gacc, macc = self._accumulate(full, local, self._weights(local),
                                      self._reduce if each else None)
        del full
        grads = gacc if each else self._reduce(gacc)
        del gacc
        keys = list(macc)
        summed = self.group.all_reduce(torch.stack([macc[k] for k in keys]))
        return grads, dict(zip(keys, summed.unbind()))

    def _reduce(self, grads):
        """This rank's blocks of gradients summed over the mesh, in float32."""
        sp = self.tp.sp

        def one(path, g):
            leaf = self.layout[path]
            g = g.float()
            if leaf.data is None:
                g = self.group.all_reduce(g)
            else:
                g = self.group.reduce_scatter(torch.stack([g[sl] for sl in leaf.data]))
            if sp and not leaf.model_split:    # partial over the sequence shards
                g = self.tp.group.all_reduce(g)
            return g

        return tree_map_with_path(one, grads)

    def global_norm(self, grads) -> torch.Tensor:
        """The gradients' norm over the mesh: each block's squares counted
        once, by the first rank that holds it."""
        sq = torch.stack([torch.sum(torch.square(g.float())) if self.layout[path].counted
                          else torch.zeros((), device=g.device)
                          for path, g in tree_leaves_with_path(grads)])
        return torch.sqrt(sum(self.world.all_reduce(sq).unbind()))

    def update(self, params, opt_state: AdamWState, grads, metrics: Dict[str, torch.Tensor]):
        """The step's work after the gradients: clip to ``GRAD_CLIP``, AdamW,
        apply -> (params, opt_state, metrics with ``grad_norm``, the norm
        before clipping).  On a mesh every tree holds this rank's blocks.
        ``grads`` are clipped in place and ``opt_state``'s moments updated in
        place (donated, as the reference's jitted step donates its state):
        the caller reads neither again."""
        with tracing.span("update"):
            with tracing.span("update.clip"):
                norm = None if self.tp is None else self.global_norm(grads)
                grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP, norm=norm, inplace=True)
            with tracing.span("update.adamw"):
                updates, opt_state = self.optimizer.update(grads, opt_state, params, self.lr)
            del grads
            with tracing.span("update.apply"):
                params = AdamW.apply_updates(params, updates)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    def __call__(self, params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        grads, metrics = self.grads(params, batch)
        return self.update(params, opt_state, grads, metrics)


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


class ServeStep(_MeshStep):
    """What the prefill and decode steps share: caches of ``max_len``
    rows for global batches of ``batch`` rows."""

    def __init__(self, model: Model, rules: MeshRules, shape: InputShape) -> None:
        super().__init__(model, rules)
        self.batch = shape.global_batch
        self.max_len = shape.seq_len


class PrefillStep(ServeStep):
    """``prefill(shards, batch) -> (last-position logits, caches)``: the
    reference's ``make_prefill_step``, with caches of ``max_len`` rows.
    ``batch`` holds ``tokens`` (B, S), and ``frames`` / ``image_embeds``
    where the family needs them."""

    kind = "prefill"

    def __call__(self, shards, batch: Dict[str, torch.Tensor]):
        if self.tp is None:
            return self.model.prefill(shards, batch["tokens"], self.max_len,
                                      frames=batch.get("frames"),
                                      image_embeds=batch.get("image_embeds"))
        local = self.local_batch(batch)
        return self.model.prefill(self.forward_params(shards), local["tokens"], self.max_len,
                                  frames=local.get("frames"),
                                  image_embeds=local.get("image_embeds"), tp=self.tp)


class DecodeStep(ServeStep):
    """``decode(shards, tokens, positions, caches) -> (logits, caches)``:
    the reference's ``make_decode_step``, one token a row against caches
    of ``max_len`` rows (this rank's, updated in place)."""

    kind = "decode"

    def __call__(self, shards, tokens: torch.Tensor, positions: torch.Tensor, caches):
        if self.tp is None:
            return self.model.decode_step(shards, tokens, positions, caches)
        local = self.local_batch({"tokens": tokens, "positions": positions})
        return self.model.decode_step(self.forward_params(shards), local["tokens"],
                                      local["positions"], caches, tp=self.tp)


def make_prefill_step(model: Model, rules: MeshRules, shape: InputShape) -> PrefillStep:
    """The prefill step for global batches of ``shape.global_batch`` rows
    into caches of ``shape.seq_len`` rows, on the mesh of ``rules``."""
    return PrefillStep(model, rules, shape)


def make_decode_step(model: Model, rules: MeshRules, shape: InputShape) -> DecodeStep:
    """The decode step for global batches of ``shape.global_batch`` rows
    against caches of ``shape.seq_len`` rows, on the mesh of ``rules``."""
    return DecodeStep(model, rules, shape)

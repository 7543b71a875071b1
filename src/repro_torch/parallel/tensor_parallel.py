"""What a model module asks of a mesh whose ``model`` axis is larger than 1.

Tensor parallelism in the Megatron form, done by hand (slice F2): each
rank holds its block of every parameter the rules split over ``model``
(heads, the FFN's hidden dim, experts or their hidden dim, the
vocabulary, the RG-LRU width) and computes on it.  Every block of a
model — attention, FFN, MoE, SSD, RG-LRU, the embedding and the loss's
head — is one *region*: a replicated activation enters it through
:meth:`TensorParallel.enter`, the ranks compute their parts, and the
parts leave it, summed, through :meth:`TensorParallel.leave`.  Inside a
region every gradient is a per-rank partial sum whose total over the
model group is the true gradient:

* an activation enters with :func:`~.collectives.copy_to` (all-reduce of
  its gradient), or under sequence parallelism with
  :func:`~.collectives.gather_seq` from the rank's sequence shard
  (reduce-scatter of its gradient); partial results leave with
  :func:`~.collectives.reduce_from`, or :func:`~.collectives.scatter_seq`
  onto the sequence shards;
* a weight a region needs whole is gathered over the group
  (:meth:`TensorParallel.full`: its gradient reduce-scattered back onto
  the blocks) if the rules split it, else it is replicated and enters
  through :meth:`TensorParallel.shared`;
* a value every rank computes whole leaves through
  :meth:`TensorParallel.whole`, each rank contributing ``1/size`` of it.

Outside the regions (the norms, the residual adds, the vision model's
gates, whisper's position table) the activations are replicated: their
leaves' gradients are equal on every model rank without sequence
parallelism, and partial over the sequence shards with it, where the
train step all-reduces every leaf the rules do not split over
``model``.  That is why :meth:`TensorParallel.shared` is the identity
under sequence parallelism: the step's all-reduce sums those partials
too.

The serving forwards (prefill and decode, slice F3a) run the same
regions without gradients.  A forward whose length the model size does
not divide runs without sequence parallelism
(:meth:`TensorParallel.at_length`).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import torch

from .collectives import Group, copy_to, gather_seq, reduce_from, scatter_seq
from .mesh_rules import MeshRules

__all__ = ["TensorParallel"]


class TensorParallel:
    """The model group of ``rules``' mesh, this rank's place in it, the data
    group (the MoE aux values' mean) and whether the residual stream is
    split on the sequence dim (``sequence_parallel``, ``act_seq`` on
    ``model``).  ``layouts`` keeps each model module's split dims once
    they are resolved (:func:`repro_torch.models.layers.model_split`)."""

    def __init__(self, rules: MeshRules) -> None:
        self.rules = rules
        self.group: Group = rules.model_group
        self.data: Group = rules.data_group
        self.size = self.group.size
        self.rank = rules.model_rank
        self.sp = self.size > 1 and "model" in rules.rules["act_seq"]
        self.layouts: Dict[tuple, Dict[str, Optional[int]]] = {}

    # -- regions ------------------------------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A residual-stream activation (B, S, ...) entering a region: whole
        on the sequence dim, replicated over the group."""
        return gather_seq(x, self.group) if self.sp else copy_to(x, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A region's partial result (B, S, ...) summed over the group, back
        in the residual stream's layout."""
        return scatter_seq(y, self.group) if self.sp else reduce_from(y, self.group)

    def shared(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight used inside a region (its gradient summed
        over the group; by the train step under sequence parallelism)."""
        return w if self.sp else copy_to(w, self.group)

    def whole(self, v: torch.Tensor) -> torch.Tensor:
        """A value every rank of the group computed whole, leaving a region."""
        return reduce_from(v / self.size, self.group)

    # -- layouts ------------------------------------------------------------
    def split_dim(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> Optional[int]:
        """The dim of a parameter of ``axes`` and (full) ``shape`` that the
        rules split over ``model``, or None."""
        spec = self.rules.spec(tuple(axes), tuple(shape))
        dims = [i for i, e in enumerate(spec)
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        return dims[0] if dims else None

    def full(self, w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole parameter of a block ``w`` that the rules split on
        ``dim`` (None: replicated), for use inside a region."""
        return self.shared(w) if dim is None else gather_seq(w, self.group, dim)

    def block(self, n: int) -> slice:
        """This rank's block of a dim of ``n`` split over the group."""
        if n % self.size:
            raise ValueError(f"a dim of {n} does not split over {self.size} model ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def heads(self, total: int) -> Tuple[int, int]:
        """(first, count) of this rank's ``total`` heads: its block where
        the group splits them by whole heads, else every head (0, total)."""
        if total % self.size:
            return 0, total
        count = total // self.size
        return self.rank * count, count

    def at_length(self, seq: int) -> "TensorParallel":
        """This group for a forward of ``seq`` positions: without sequence
        parallelism where the model size does not divide ``seq`` (a decode
        step's one token, an odd prompt), whose dim the reference's
        divisibility rule replicates.  The view shares ``layouts``."""
        if not self.sp or seq % self.size == 0:
            return self
        view = copy.copy(self)
        view.sp = False
        return view

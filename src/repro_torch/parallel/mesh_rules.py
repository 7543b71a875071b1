"""Logical-axis → mesh-axis sharding rules (MaxText-style, divisibility-aware).

The port's copy of ``repro.parallel.mesh_rules``.  Parameters and
activations are annotated with *logical* axis names (``"embed"``,
``"qheads"``, ``"act_batch"`` …); :class:`MeshRules` resolves them
against a mesh:

* each logical name has a priority-ordered tuple of candidate mesh axes;
* a candidate is used only if it exists in the mesh, is not already used
  by another dim of the same tensor, and divides the dim size evenly —
  so e.g. grok-1's 8 experts fall back from expert-parallel to
  tensor-parallel over the expert FFN dim, and a batch of 1 falls back
  to replication;
* :class:`~repro_torch.configs.base.ParallelConfig` switches (fsdp /
  tensor_parallel / replicate_kv / sequence_parallel) prune the rule table.

:meth:`MeshRules.spec` returns a plain tuple, one entry per dim: a mesh
axis name, a tuple of names (the dim sharded over their product, the
first name major), or ``None`` — the values of the reference's
``PartitionSpec``.  :meth:`MeshRules.local_slice` turns a spec into the
index of one rank's shard.  The mesh is a ``torch.distributed`` ``DeviceMesh`` or
a :class:`MeshShape`, which needs no process group (rank-free tests, and
the one-device (1, 1) mesh of ``run_training``).

On a ``DeviceMesh`` the rules also hold one :class:`Group` per mesh axis
the models and the train step run collectives over:
:attr:`MeshRules.model_group` (the ``model`` axis) and
:attr:`MeshRules.data_group` (``pod`` × ``data``), and this rank's
``model`` coordinate (:attr:`MeshRules.model_rank`).  On a
:class:`MeshShape` of several ranks those groups are shape-only
(:class:`~.collectives.ShapeGroup` of the axes' sizes): the dry-run's
one-rank step on ``meta`` tensors, where rank 0's coordinate stands for
every rank (a production mesh's ranks hand equal bytes).

:func:`shard_hint` is the identity.  The port's layouts are explicit: on
a data-parallel mesh the train step gathers the weights and splits the
batch by hand (``launch/steps.py``), and on a model axis larger than 1
the models call named collectives (:mod:`.tensor_parallel`) where the
reference's hints change an activation's layout: ``models/attention.py``
for ``src/repro/models/attention.py:243, 256-257, 337, 341``,
``models/ffn.py`` for ``ffn.py:26, 28, 42, 44``, ``models/moe.py`` for
``moe.py:59-68, 94-105`` and ``core/moe_dispatch.py:195, 199``,
``models/ssm.py`` for ``ssm.py:215``, ``models/rglru.py`` for
``rglru.py:116, 157``, ``models/transformer.py`` for
``transformer.py:321`` and ``models/encdec.py`` for ``encdec.py:90,
162``.  A collective cannot hide inside an annotation there.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..configs.base import ParallelConfig
from .collectives import Group, ShapeGroup

__all__ = ["MeshShape", "MeshRules", "Spec", "DATA_AXES", "use_rules", "current_rules",
           "hints_disabled", "shard_hint", "is_axes", "axes_leaves"]

Axes = Tuple[Optional[str], ...]
DATA_AXES = ("pod", "data")
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis → candidate mesh axes (priority order).  A tuple value of
# length > 1 with all candidates taken means the dim is sharded over the
# product of those axes (e.g. batch over pod×data).
_DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": (),               # sequence dim; ("model",) under SP
    "act_embed": (),             # hidden dim of activations: replicated
    "act_heads": ("model",),
    "act_kv": ("model",),
    "act_mlp": ("model",),
    "act_experts": ("model",),
    # expert-capacity chunks stay token-parallel over the DP axes, for an
    # expert count that does not divide the model axis (grok-1: 8 experts)
    "act_capacity": ("pod", "data"),
    "act_vocab": ("model",),
    # parameters
    "vocab": ("model",),
    "embed": ("data", "pod"),    # FSDP shard of the contracting dim; the pod
                                 # axis joins on multi-pod meshes
    "qheads": ("model",),
    "kvheads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_embed": ("data", "pod"),
    "expert_mlp": ("model",),
    "lru": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "ssm_heads": (),
    "conv_ch": ("model",),
    "heads_vec": (),             # per-head scales (qk-norm etc.)
    "stack": (),                 # the reference's scan-stacked layer dim
    "window": (),
    "img_tokens": (),
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and axis names, with no process group behind it (the
    rank's coordinate is all zeros)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def get_coordinate(self) -> Tuple[int, ...]:
        return (0,) * len(self.shape)


def is_axes(x) -> bool:
    """A leaf of a spec tree: a tuple of logical axis names or ``None``."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def axes_leaves(specs_tree) -> list:
    """The logical-axes tuples of a spec tree (``Model.param_specs()``), in
    the order ``tree.tree_leaves`` gives the parameters."""
    if is_axes(specs_tree):
        return [specs_tree]
    items = specs_tree.values() if isinstance(specs_tree, dict) else specs_tree
    return [axes for v in items for axes in axes_leaves(v)]


class MeshRules:
    def __init__(self, mesh, parallel: ParallelConfig) -> None:
        self.mesh = mesh
        self.parallel = parallel
        self.axis_sizes: Dict[str, int] = dict(zip(mesh.mesh_dim_names,
                                                   (int(n) for n in tuple(mesh.shape))))
        rules = dict(_DEFAULT_RULES)
        if not parallel.fsdp:
            rules["embed"] = ()
            rules["expert_embed"] = ()
        if parallel.replicate_kv:
            rules["kvheads"] = ()
            rules["act_kv"] = ()
        if not parallel.tensor_parallel:
            for k, v in rules.items():
                rules[k] = tuple(a for a in v if a != "model")
        if parallel.sequence_parallel:
            rules["act_seq"] = ("model",)
        self.rules = rules

    def spec(self, axes: Axes, shape: Optional[Sequence[int]] = None) -> Spec:
        """Resolve logical axes (+ optional dim sizes for divisibility)."""
        used: set = set()
        out = []
        for i, ax in enumerate(axes):
            if ax is None:
                out.append(None)
                continue
            if ax not in self.rules:
                raise KeyError(f"unknown logical axis {ax!r}")
            chosen = []
            for cand in self.rules[ax]:
                if cand not in self.axis_sizes or cand in used:
                    continue
                size = self.axis_sizes[cand]
                cur = math.prod(self.axis_sizes[c] for c in chosen)
                if shape is not None and shape[i] % (cur * size) != 0:
                    continue
                chosen.append(cand)
            used.update(chosen)
            out.append(None if not chosen else chosen[0] if len(chosen) == 1 else tuple(chosen))
        return tuple(out)

    def coordinate(self) -> Dict[str, int]:
        """This rank's coordinate on each mesh axis."""
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))

    @property
    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the ``model`` axis."""
        return self.coordinate().get("model", 0)

    @property
    def shape_only(self) -> bool:
        """Whether the mesh is a :class:`MeshShape`: its groups are
        shape-only (:class:`ShapeGroup`), for a step on ``meta`` tensors."""
        return isinstance(self.mesh, MeshShape)

    def _device_mesh(self, axes: Sequence[str]):
        """The ``DeviceMesh`` that collectives over ``axes`` run on."""
        if not hasattr(self.mesh, "mesh"):
            raise ValueError(f"collectives over {tuple(axes)} need a DeviceMesh over a "
                             "process group (launch.mesh.make_mesh)")
        return self.mesh

    @functools.cached_property
    def world_group(self) -> Group:
        """Every rank of the mesh (the default group)."""
        size = math.prod(self.axis_sizes.values())
        if self.shape_only:
            return ShapeGroup(size, name="world") if size > 1 else Group(alone=True)
        return Group()

    @functools.cached_property
    def model_group(self) -> Group:
        """The ``model`` axis's group: the ranks that share this rank's data
        coordinates (shape-only on a :class:`MeshShape`)."""
        if self.model_size == 1:
            return Group(alone=True)
        if self.shape_only:
            return ShapeGroup(self.model_size, self.model_rank, name="model")
        return Group(self._device_mesh(["model"]).get_group("model"))

    @functools.cached_property
    def data_group(self) -> Group:
        """The data axes' group (``pod`` × ``data``): the ranks that share this
        rank's ``model`` coordinate (shape-only on a :class:`MeshShape`).  It
        is the default group when the data axes span the mesh."""
        axes = [a for a in self.mesh.mesh_dim_names if a in DATA_AXES]
        size = math.prod(self.axis_sizes[a] for a in axes)
        if size == 1:
            return Group(alone=True)
        if self.shape_only:
            return ShapeGroup(size, name="data")
        mesh = self._device_mesh(axes)
        if size == math.prod(self.axis_sizes.values()):
            return Group()
        if len(axes) == 1:
            return Group(mesh.get_group(axes[0]))
        import torch.distributed as dist

        # one group per coordinate of the other axes, made by every rank in order
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in names if a not in axes] + [names.index(a) for a in axes]
        rows = mesh.mesh.permute(order).reshape(-1, size)
        mine = None
        for row in rows.tolist():
            pg = dist.new_group(row)
            if dist.get_rank() in row:
                mine = pg
        return Group(mine)

    def rank_coordinates(self, ranks: Sequence[int]) -> List[Dict[str, int]]:
        """Each global rank's coordinate on the mesh (row-major ranks)."""
        if not self.shape_only:
            mesh = self.mesh
            return [dict(zip(mesh.mesh_dim_names, (mesh.mesh == k).nonzero()[0].tolist()))
                    for k in ranks]
        out = []
        for k in ranks:
            coord = {}
            for name, n in reversed(list(self.axis_sizes.items())):
                k, coord[name] = divmod(k, n)
            out.append({name: coord[name] for name in self.mesh.mesh_dim_names})
        return out

    def local_slice(self, spec: Spec, shape: Sequence[int],
                    coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
        """The index of the shard that the rank at ``coords`` (mesh axis →
        coordinate; this rank's by default) holds of a tensor of ``shape``
        laid out by ``spec``.  A dim sharded over several axes splits into
        their product's blocks, the first axis major, as the reference's
        ``PartitionSpec`` does."""
        coords = self.coordinate() if coords is None else coords
        out = []
        for entry, n in zip(spec, shape):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            block, index = n, 0
            for name in names:
                size = self.axis_sizes[name]
                block //= size
                index = index * size + coords[name]
            out.append(slice(index * block, (index + 1) * block) if names else slice(None))
        return tuple(out)


# ---------------------------------------------------------------------------
# ambient rules (so model code can hint shardings without plumbing)
# ---------------------------------------------------------------------------
_ACTIVE: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None)
_HINTS_DISABLED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_hints_disabled", default=False)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def hints_disabled():
    """Suppress shard hints: inside a per-rank body, values are the rank's
    own blocks and global layouts are meaningless."""
    token = _HINTS_DISABLED.set(True)
    try:
        yield
    finally:
        _HINTS_DISABLED.reset(token)


def current_rules() -> Optional[MeshRules]:
    return _ACTIVE.get()


def shard_hint(x, *axes: Optional[str]):
    """Annotate an activation with logical axes: the identity (the port's
    layouts are explicit; see the module docstring)."""
    return x

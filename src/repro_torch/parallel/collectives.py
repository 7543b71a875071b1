"""Collectives over one mesh axis's process group, those that carry
gradients, and the compressed psum.

:class:`Group` wraps one ``torch.distributed`` process group (or none: a
group of one rank, where every collective is the identity) with the
collectives the port's distributed paths run: all-reduce, broadcast,
all-gather and reduce-scatter of flat tensors, and point-to-point
send / recv.  It counts the bytes this rank hands to them
(``sent_bytes``).  :class:`ShapeGroup` is its shape-only stand-in for the
dry-run: the same interface and counts on ``meta`` tensors, nothing moved.

**Collectives that carry gradients** (tensor and sequence parallelism,
slice F2), each a ``torch.autograd.Function`` over a :class:`Group`
whose forward and backward both count their bytes:

* :func:`copy_to` — identity forward, all-reduce backward: a replicated
  activation (or weight) entering a computation that each rank does on
  its own block, whose gradients are per-rank partial sums;
* :func:`reduce_from` — all-reduce forward, identity backward: the
  partial results leaving such a computation;
* :func:`gather_seq` — all-gather along a dim forward, reduce-scatter
  backward (the sequence-parallel residual entering a block, or a
  weight gathered over the group);
* :func:`scatter_seq` — reduce-scatter forward, all-gather backward (the
  block's partial results back onto the sequence shards);
* :func:`pmean` — the group's mean forward, the mean of the cotangents
  backward (the MoE aux values over the data axes, whose ranks weigh
  their losses by their share of the batch).

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which multiplies a gradient by the group's size when
every rank computes the same loss.  These five run no point-to-point
transfer, so nothing of them is staged through the host.

**Host staging.**  On one card two ranks cannot share NCCL ("Duplicate
GPU detected"), so they share gloo.  Gloo takes CUDA tensors in
``all_reduce`` and ``broadcast`` (its documented table) and, on the
H100 machine's PyTorch 2.11, in ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` too (``chip_smoke.py`` phase 8 runs them
there); its point-to-point ``send`` / ``recv`` of a CUDA tensor fail in
its TCP transport ("writev: Bad address"), and the failure can be thrown
on gloo's own thread, where it aborts the process instead of raising, so
they are never tried unstaged.  Those two are staged here, and only here: the tensor is copied to a pinned host buffer, sent or
received there, and copied back.  This is transport, not compute; it
counts the bytes it copies (``staged_bytes``, both directions), and it
never runs when the backend is NCCL or the tensors are on the CPU.

:func:`compressed_psum` is the reference's int8 all-reduce step for step:
each rank's scale (its max |x|, at least 1e-12, over 127) is maxed across
the group so the quanta are commensurable, ``x / scale`` is rounded half
to even (``torch.round`` as ``jnp.round``) and clipped to ±127 as int8,
the int32 sum of the quanta is all-reduced, and the sum dequantized.  As
in the reference, the sum runs in int32, so the bytes on the wire are
those of float32; the int8 payload is what an all-gather of the quanta
would carry.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import costs
from ..tree import tree_map

__all__ = ["Group", "ShapeGroup", "COLLECTIVE_KINDS", "copy_to", "reduce_from", "gather_seq",
           "scatter_seq", "pmean", "compressed_psum", "compressed_psum_tree"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Group:
    """One process group (``None``: the default group when one is
    initialised, else a group of this rank alone; ``alone=True``: this
    rank alone in any case)."""

    def __init__(self, pg: Optional[dist.ProcessGroup] = None, *, alone: bool = False) -> None:
        self.pg = pg
        active = not alone and dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size(pg) if active else 1
        self.rank = dist.get_rank(pg) if active else 0
        self.backend = dist.get_backend(pg) if active else None
        self.sent_bytes = 0
        self.staged_bytes = 0

    def _global(self, rank: int) -> int:
        return rank if self.pg is None else dist.get_global_rank(self.pg, rank)

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a point-to-point transfer of ``t`` goes through the host."""
        return self.backend == "gloo" and t.is_cuda

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        self.staged_bytes += t.numel() * t.element_size()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    def _back(self, host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        self.staged_bytes += host.numel() * host.element_size()
        return like.copy_(host)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group, in place."""
        if self.size > 1:
            self.sent_bytes += t.numel() * t.element_size()
            dist.all_reduce(t, op=_OPS[op], group=self.pg)
        return t

    def all_reduce_float(self, x: float, op: str = "sum") -> float:
        """A host number reduced over the group (through the card for NCCL,
        which takes no host tensors)."""
        t = torch.tensor([x], dtype=torch.float64,
                         device="cuda" if self.backend == "nccl" else "cpu")
        return float(self.all_reduce(t, op)[0])

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of group rank ``src`` on every rank, in place."""
        if self.size > 1:
            if self.rank == src:
                self.sent_bytes += t.numel() * t.element_size()
            dist.broadcast(t, src=self._global(src), group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, in group-rank order."""
        t = t.contiguous()
        out = torch.empty((self.size, *t.shape), dtype=t.dtype, device=t.device)
        if self.size == 1:
            return out.copy_(t[None])
        self.sent_bytes += t.numel() * t.element_size()
        dist.all_gather_into_tensor(out.view(-1), t.view(-1), group=self.pg)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...) summed over the group; this rank's row of the sum."""
        t = t.contiguous()
        out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
        if self.size == 1:
            return out.copy_(t[0])
        self.sent_bytes += t.numel() * t.element_size()
        dist.reduce_scatter_tensor(out.view(-1), t.view(-1), op=dist.ReduceOp.SUM, group=self.pg)
        return out

    def send(self, t: torch.Tensor, dst: int) -> None:
        t = t.contiguous()
        self.sent_bytes += t.numel() * t.element_size()
        dist.send(self._to_host(t) if self._staged(t) else t, dst=self._global(dst),
                  group=self.pg)

    def recv(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Group rank ``src``'s tensor into ``t`` (contiguous), in place."""
        if self._staged(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dist.recv(host, src=self._global(src), group=self.pg)
            return self._back(host, t)
        dist.recv(t, src=self._global(src), group=self.pg)
        return t


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "broadcast", "send")


class ShapeGroup:
    """A group of ``size`` ranks that exists only as a shape: the dry-run's
    stand-in for a :class:`Group` of a production mesh, which no host can
    spawn.  It has :class:`Group`'s interface and adds to ``sent_bytes``
    exactly where :class:`Group` does, but moves nothing: it takes and
    returns ``meta`` tensors of the shapes :class:`Group` returns, and
    raises on any tensor that is not on ``meta``.  ``by_kind`` splits the
    bytes by collective (:data:`COLLECTIVE_KINDS`), and each collective is
    charged to the active cost report (``repro_torch.costs``), scaled as
    the report runs it.

    :meth:`all_reduce_float` has no value to reduce: every rank stands for
    ``rank`` (the dry-run's rank 0), so the stand-in of a sum is ``size``
    times the rank's number and of a max the number itself."""

    backend = "shape"
    pg = None

    def __init__(self, size: int, rank: int = 0, name: str = "") -> None:
        self.size = size
        self.rank = rank
        self.name = name
        self.sent_bytes = 0
        self.staged_bytes = 0
        self.by_kind = {kind: 0 for kind in COLLECTIVE_KINDS}

    def _count(self, kind: str, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size() * costs.scale()
        self.sent_bytes += n
        self.by_kind[kind] += n
        costs.charge_collective(self.name, kind, tuple(t.shape), t.dtype, n)

    @staticmethod
    def _meta(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "meta":
            raise ValueError(f"a shape-only group moves no data: it takes meta tensors, got one "
                             f"on {t.device}")
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op not in _OPS:
            raise KeyError(op)
        if self.size > 1:
            self._count("all-reduce", self._meta(t))
        return self._meta(t)

    def all_reduce_float(self, x: float, op: str = "sum") -> float:
        if self.size > 1:
            self._count("all-reduce", torch.empty(1, dtype=torch.float64, device="meta"))
        return float(x) * (self.size if op == "sum" else 1)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        if self.size > 1 and self.rank == src:
            self._count("broadcast", self._meta(t))
        return self._meta(t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = self._meta(t).contiguous()
        if self.size > 1:
            self._count("all-gather", t)
        return torch.empty((self.size, *t.shape), dtype=t.dtype, device="meta")

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        t = self._meta(t).contiguous()
        if self.size > 1:
            self._count("reduce-scatter", t)
        return torch.empty(t.shape[1:], dtype=t.dtype, device="meta")

    def send(self, t: torch.Tensor, dst: int) -> None:
        self._count("send", self._meta(t).contiguous())

    def recv(self, t: torch.Tensor, src: int) -> torch.Tensor:
        return self._meta(t)


def _split(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """(n, ...): ``t`` cut into n equal blocks along ``dim``."""
    if t.shape[dim] % n:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over {n} ranks")
    return torch.stack(t.chunk(n, dim=dim))


def _gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return torch.cat(group.all_gather(t).unbind(0), dim=dim)


def _scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return group.reduce_scatter(_split(t, group.size, dim))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format)) / group.size

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone(memory_format=torch.contiguous_format)) / \
            ctx.group.size, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x``; its gradient summed over the group."""
    return x if group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` summed over the group; its gradient passed through."""
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


def gather_seq(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group-rank order; the
    gradient summed over the group, this rank's block kept."""
    return x if group.size == 1 else _GatherSeq.apply(x, group, dim)


def scatter_seq(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over the group; the
    gradient gathered."""
    return x if group.size == 1 else _ScatterSeq.apply(x, group, dim)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x``'s mean over the group; the gradient the mean of the ranks'."""
    return x if group.size == 1 else _PMean.apply(x, group)


def compressed_psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """All-reduce with int8 quanta on a shared grid (the reference's)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    scale = group.all_reduce(scale.reshape(1), "max")[0]  # shared grid
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = group.all_reduce(q.to(torch.int32), "sum")    # int payload
    return (total.float() * scale).to(x.dtype)


def compressed_psum_tree(tree, group: Group):
    return tree_map(lambda g: compressed_psum(g, group), tree)

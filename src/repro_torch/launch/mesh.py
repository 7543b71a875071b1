"""Mesh construction and the card's roofline constants.

The port's counterpart of ``repro.launch.mesh``.  :func:`make_mesh`
builds a ``DeviceMesh`` over the initialised process group; a one-device
run needs no process group and uses ``parallel.mesh_rules.MeshShape((1,
1), ("data", "model"))`` instead.  :func:`make_production_mesh` (16×16
``("data", "model")`` and 2×16×16 ``("pod", "data", "model")``) and
:func:`make_test_mesh` return rank-free ``MeshShape`` values: no host can
spawn 256 ranks, so the dry-run (``launch/dryrun.py``) runs one rank's
step on ``meta`` tensors over shape-only groups of those sizes.

:class:`HardwareSpec` holds the published peaks of the target part;
:data:`H100_SXM` is NVIDIA's data sheet for the H100 SXM (dense rates,
without sparsity, at its 700 W power limit), the part the port's roofline
bounds divide by, with its interconnect: NVLink inside a node of 8 GPUs
behind NVSwitch, one 400 Gb/s NDR InfiniBand port a GPU between nodes.
:meth:`HardwareSpec.group_rate` prices a mesh axis's group at the slowest
link it crosses (ranks laid out row-major, 8 to a node).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from ..parallel.mesh_rules import MeshShape

__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh", "HardwareSpec", "H100_SXM"]


def make_mesh(shape: Tuple[int, ...] = (2, 1), axes: Tuple[str, ...] = ("data", "model"), *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group
    (which the caller has initialised, with a world size of the shape's
    product), ranks laid out row-major."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh as a rank-free shape: 16×16 = 256 GPUs
    ``("data", "model")``, or 2×16×16 = 512 with a leading ``pod`` axis."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")) -> MeshShape:
    """A small rank-free mesh shape (the dry-run's tests)."""
    return MeshShape(tuple(shape), tuple(axes))


class HardwareSpec:
    """Roofline constants for the target part and its interconnect."""

    def __init__(self, name: str, peak_flops: float, f32_flops: float, hbm_bw: float,
                 hbm_bytes: float, intra_node_bw: float, node_size: int,
                 inter_node_bw: float, sms: int) -> None:
        self.name = name
        self.peak_flops = peak_flops        # FLOP/s bf16 on the tensor cores
        self.f32_flops = f32_flops          # FLOP/s float32 outside the tensor cores
        self.hbm_bw = hbm_bw                # device memory bytes/s
        self.hbm_bytes = hbm_bytes          # device memory capacity
        self.intra_node_bw = intra_node_bw  # bytes/s a GPU sends inside a node
        self.node_size = node_size          # GPUs a node
        self.inter_node_bw = inter_node_bw  # bytes/s a GPU sends to other nodes
        self.sms = sms                      # streaming multiprocessors: a wave of CTAs

    def group_rate(self, mesh_shape: Sequence[int], axis_names: Sequence[str],
                   group_axes: Sequence[str]) -> float:
        """Bytes/s a rank hands to the group over ``group_axes`` of a mesh
        (ranks row-major, ``node_size`` to a node): the slowest link the
        group of rank 0 crosses, NVLink when it stays in one node."""
        strides = {name: math.prod(mesh_shape[i + 1:]) for i, name in enumerate(axis_names)}
        sizes = dict(zip(axis_names, mesh_shape))
        ranks = [0]
        for ax in group_axes:
            ranks = [r + j * strides[ax] for r in ranks for j in range(sizes[ax])]
        nodes = {r // self.node_size for r in ranks}
        return self.intra_node_bw if len(nodes) == 1 else self.inter_node_bw


# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 (dense), 67 TFLOP/s fp32,
# 3.35 TB/s HBM3, 80 GB, 132 SMs; NVLink 4 at 900 GB/s a GPU in total, 450 GB/s a
# direction, 8 GPUs a node behind NVSwitch (H100 data sheet); one 400 Gb/s
# NDR InfiniBand port a GPU, 50 GB/s, between nodes (NVIDIA DGX H100 data sheet)
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    f32_flops=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    intra_node_bw=450e9,
    node_size=8,
    inter_node_bw=50e9,
    sms=132,
)

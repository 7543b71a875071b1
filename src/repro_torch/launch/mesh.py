"""Mesh construction and the card's roofline constants.

The port's counterpart of ``repro.launch.mesh``.  :func:`make_mesh`
builds a ``DeviceMesh`` over the initialised process group (the
counterpart of ``make_test_mesh``); a one-device run needs no process
group and uses ``parallel.mesh_rules.MeshShape((1, 1), ("data",
"model"))`` instead.  ``make_production_mesh`` (16×16 and 2×16×16) waits
for slice F3b, the dry-run, its only user.

:class:`HardwareSpec` holds the published peaks of the target part;
:data:`H100_SXM` is NVIDIA's data sheet for the H100 SXM (dense rates,
without sparsity, at its 700 W power limit), the part the port's roofline
bounds divide by.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["make_mesh", "HardwareSpec", "H100_SXM"]


def make_mesh(shape: Tuple[int, ...] = (2, 1), axes: Tuple[str, ...] = ("data", "model"), *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group
    (which the caller has initialised, with a world size of the shape's
    product), ranks laid out row-major."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


class HardwareSpec:
    """Roofline constants for the target part."""

    def __init__(self, name: str, peak_flops: float, f32_flops: float, hbm_bw: float,
                 hbm_bytes: float) -> None:
        self.name = name
        self.peak_flops = peak_flops      # FLOP/s bf16 on the tensor cores
        self.f32_flops = f32_flops        # FLOP/s float32 outside the tensor cores
        self.hbm_bw = hbm_bw              # device memory bytes/s
        self.hbm_bytes = hbm_bytes        # device memory capacity


# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 (dense), 67 TFLOP/s fp32,
# 3.35 TB/s HBM3, 80 GB
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    f32_flops=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
)

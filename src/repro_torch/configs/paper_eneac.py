"""The paper's own benchmark configurations (ENEAC §4).

HOTSPOT: Rodinia thermal stencil, 2048×2048 chip grid, iteration space =
2048 rows.  SPMM: 29957×29957 sparse × 29957×100 dense, iteration space =
29957 rows.  Table-1 sweeps FPGA chunk sizes; the throughput cliff sits at
chunk > 1/4 of the space (512 rows HOTSPOT, 8192 rows SPMM).
"""

from dataclasses import dataclass
from typing import Tuple

__all__ = ["HotspotConfig", "SpmmConfig", "HOTSPOT", "SPMM", "TABLE1_CONFIGS"]


@dataclass(frozen=True)
class HotspotConfig:
    grid: int = 2048            # chip is grid × grid points
    iterations: int = 2048      # parallel rows
    sim_steps: int = 8          # time steps per run (paper loops the solver)
    # physical constants from the Rodinia kernel
    t_chip: float = 0.0005
    chip_height: float = 0.016
    chip_width: float = 0.016
    max_pd: float = 3.0e6
    precision: float = 0.001
    spec_heat_si: float = 1.75e6
    k_si: float = 100.0
    amb_temp: float = 80.0
    # chunk sweep (paper Fig. 4a): cliff above 512 (= grid/4)
    chunk_sweep: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)


@dataclass(frozen=True)
class SpmmConfig:
    rows: int = 29957
    cols: int = 29957
    dense_cols: int = 100
    nnz_per_row_mean: float = 120.0   # irregular: lognormal row lengths
    nnz_per_row_sigma: float = 1.0
    seed: int = 1234
    chunk_sweep: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192, 16384)


HOTSPOT = HotspotConfig()
SPMM = SpmmConfig()

# Table-1 platform configurations, reproduced on the TPU mapping:
#   CC   = VPU/gather path (jnp row-wise)           [CPU cores]
#   HP   = Pallas kernel, HBM re-fetch per step     [non-cacheable port]
#   HPC  = Pallas kernel, VMEM-resident revisiting  [cache-coherent port]
#   +INT = completion-driven AsyncEngine            [interrupt mechanism]
TABLE1_CONFIGS = (
    ("1", "4CC", "cc", None, False),
    ("2", "4HPACC", "acc", "hp", False),
    ("3", "4HPCACC", "acc", "hpc", False),
    ("4", "4CC+4HPACC", "hybrid", "hp", False),
    ("5", "4CC+4HPACC+INT", "hybrid", "hp", True),
    ("6", "4CC+4HPCACC", "hybrid", "hpc", False),
    ("7", "4CC+4HPCACC+INT", "hybrid", "hpc", True),
)

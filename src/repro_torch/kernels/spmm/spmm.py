"""Block-ELL SPMM kernel K3: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.spmm.spmm``; the CUDA source is
``repro_torch/csrc/spmm.cu``.  :func:`spmm_block_ell` (K3) replaces
``spmm.py::spmm_block_ell_pallas``, the accelerator path: per 8-row block,
``out = Σ_{k<count} vals[rb,k] (8×128) @ rhs[cb_k·128 : +128, :]`` in IEEE
f32 on the CUDA cores (no TF32: the tolerance is 1e-4).

Bound on the card: bytes.  The function must read ``vals`` once (3.56 GB
at the paper's size, 1.07 ms at 3.35 TB/s with rhs, out and the indices);
only 0.66 % of an occupied block is nonzero there, so its 2·nnz·N flops
take 0.02 ms.  One CTA per row block streams that block row's occupied
blocks, one contiguous run, through shared memory with bulk asynchronous
copies, lists each row's nonzeros with warp ballots, and reads from L2
only the rhs rows of nonzero entries: about 6.8 nonzeros a block replace
128 rhs rows and 1024 multiply-adds per column.

The kernel adds only the nonzero entries; the plain version adds all of
them, each a rounded multiply and a rounded add in ascending (k, c)
order.  For finite rhs the two agree bitwise: a zero entry adds ±0, which
leaves the sum as it is, and the sum (from +0) never becomes −0.  The
TPU kernel's skip of the blocks ``k ≥ count`` already assumes as much.
At the paper's size a row sums up to ~30k terms, and two summation orders
differ by more than the reference's 1e-4, so the order is kept.

The wrapper takes the plain PyTorch version for tensors on the CPU,
launches the kernel for CUDA tensors, and counts its launches in
``spmm_block_ell.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from ... import _build
from .ref import BlockEll, COL_BLOCK, ROW_BLOCK

__all__ = ["BlockEllArrays", "spmm_block_ell", "spmm_block_ell_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _P)


class BlockEllArrays:
    """Tensors of a host :class:`~repro_torch.kernels.spmm.ref.BlockEll` on a device.

    Takes any object with the fields ``vals``, ``colblocks``, ``counts``,
    ``rows`` and ``n_cols`` as numpy arrays and ints, the reference
    package's ``BlockEll`` included.
    """

    def __init__(self, be: BlockEll, device: Union[str, torch.device] = "cuda"):
        k_max = be.colblocks.shape[1] if be.colblocks.ndim == 2 else 0
        if be.counts.size and not 0 <= be.counts.min() <= be.counts.max() <= k_max:
            raise ValueError(f"block-ELL counts must lie in [0, {k_max}]")
        # the largest column block any row block reads: K3 checks it against rhs
        self.max_colblock = int(be.colblocks.max(initial=0))
        if be.colblocks.size and be.colblocks.min() < 0:
            raise ValueError("block-ELL column blocks must be >= 0")
        self.vals = torch.from_numpy(be.vals).to(device)
        self.colblocks = torch.from_numpy(be.colblocks).to(device)
        self.counts = torch.from_numpy(be.counts).to(device)
        self.rows = int(be.rows)
        self.n_cols = int(be.n_cols)

    def row_blocks(self, n_rows: int) -> "BlockEllArrays":
        """The leading row blocks that cover ``n_rows`` rows, as views."""
        sub = self.row_block_range(0, (n_rows + ROW_BLOCK - 1) // ROW_BLOCK)
        sub.rows = n_rows
        return sub

    def row_block_range(self, start: int, stop: int) -> "BlockEllArrays":
        """Row blocks ``start:stop`` (rows ``8·start:8·stop``), as views."""
        sub = object.__new__(BlockEllArrays)
        sub.vals = self.vals[start:stop]
        sub.colblocks = self.colblocks[start:stop]
        sub.counts = self.counts[start:stop]
        sub.max_colblock = self.max_colblock
        sub.rows = sub.counts.shape[0] * ROW_BLOCK
        sub.n_cols = self.n_cols
        return sub


def _check(ell: BlockEllArrays, rhs: torch.Tensor) -> None:
    n_rb, k_max = ell.colblocks.shape
    if ell.vals.shape != (n_rb, k_max, ROW_BLOCK, COL_BLOCK) or ell.counts.shape != (n_rb,):
        raise ValueError(
            f"block-ELL shapes disagree: vals {tuple(ell.vals.shape)}, colblocks "
            f"{tuple(ell.colblocks.shape)}, counts {tuple(ell.counts.shape)}"
        )
    if rhs.dim() != 2 or rhs.shape[0] % COL_BLOCK:
        raise ValueError(f"rhs must be (C_pad, N) with C_pad % {COL_BLOCK} == 0, "
                         f"got {tuple(rhs.shape)}")
    if ell.max_colblock >= rhs.shape[0] // COL_BLOCK:
        raise ValueError(f"column block {ell.max_colblock} lies past rhs's "
                         f"{rhs.shape[0] // COL_BLOCK} blocks")
    if ell.vals.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 values and rhs, got {ell.vals.dtype}, {rhs.dtype}")
    if ell.colblocks.dtype != torch.int32 or ell.counts.dtype != torch.int32:
        raise TypeError("K3 takes int32 colblocks and counts")
    devices = {t.device for t in (ell.vals, ell.colblocks, ell.counts, rhs)}
    if len(devices) != 1:
        raise ValueError(f"K3's inputs lie on several devices: {devices}")
    if rhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 runs on cpu or cuda, got {rhs.device}")
    if rhs.device.type == "cuda" and not all(
            t.is_contiguous() for t in (ell.vals, ell.colblocks, ell.counts, rhs)):
        raise ValueError("the CUDA K3 kernel takes contiguous tensors")
    if rhs.device.type == "cuda" and ell.vals.data_ptr() % 16:
        raise ValueError("the CUDA K3 kernel copies vals in 16-byte units: align it to 16 bytes")


def spmm_block_ell_plain(ell: BlockEllArrays, rhs: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version, in the kernel's order and rounding.

    A loop over k gathers the (n_rb, 128, N) right-hand blocks; within a
    block, the sum over its 128 columns is a rank-1 update per column
    (a rounded multiply, then a rounded add), as the kernel does it for
    the nonzero entries (the zero ones add ±0 here, nothing there).
    Column blocks past a row block's count are masked with a 0/1 factor, as
    the reference kernel does; the loop stops at the largest count.
    """
    n_rb = ell.colblocks.shape[0]
    n = rhs.shape[1]
    rhs_blocks = rhs.view(-1, COL_BLOCK, n)
    acc = torch.zeros((n_rb, ROW_BLOCK, n), dtype=torch.float32, device=rhs.device)
    k_stop = int(ell.counts.max()) if n_rb else 0
    for k in range(k_stop):
        live = (k < ell.counts).to(torch.float32)[:, None, None]
        a = ell.vals[:, k] * live                               # (n_rb, 8, 128)
        b = rhs_blocks[ell.colblocks[:, k].long()]              # (n_rb, 128, N)
        for c in range(COL_BLOCK):
            acc = acc + a[:, :, c, None] * b[:, None, c, :]
    return acc.reshape(n_rb * ROW_BLOCK, n)


def spmm_block_ell(ell: BlockEllArrays, rhs: torch.Tensor) -> torch.Tensor:
    """Block-ELL × dense through K3; returns (n_rb · ROW_BLOCK, N)."""
    _check(ell, rhs)
    if rhs.device.type == "cpu":
        return spmm_block_ell_plain(ell, rhs)
    n_rb, k_max = ell.colblocks.shape
    n = rhs.shape[1]
    out = torch.empty((n_rb * ROW_BLOCK, n), dtype=torch.float32, device=rhs.device)
    launch = _build.function("spmm", "spmm_block_ell_launch", _ARGS)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        err = launch(ell.counts.data_ptr(), ell.colblocks.data_ptr(), ell.vals.data_ptr(),
                     rhs.data_ptr(), out.data_ptr(), n_rb, k_max, n, stream)
    _build.check("spmm", err, "spmm_block_ell launch")
    _build.count_launch(spmm_block_ell)
    return out


spmm_block_ell.launches = 0

"""SSD chunked scan, K5: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.ssd_scan.ssd_scan``; the CUDA source is
``repro_torch/csrc/ssd_scan.cu``.  :func:`ssd_scan` (K5) replaces
``ssd_scan_pallas``: per chunk of ``Q`` steps, with ``cs = cumsum(log_a)``,

    y  = (C·Bᵀ ⊙ tril(exp(cs_i − cs_j)))·x + exp(cs)·(C·hᵀ)
    h' = exp(cs_Q)·h + (x ⊙ exp(cs_Q − cs))ᵀ·B

carrying the (P, N) state ``h`` from chunk to chunk.  It adds what the
model needs and the TPU kernel lacks: a carried-in state ``h0`` and any
sequence length (the last chunk may be partial, as if padded with
``log_a = 0`` and ``B = 0``).

The plain version is :func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked`.
The wrapper takes it for tensors on the CPU, launches the kernel for CUDA
tensors, and counts its launches in ``ssd_scan.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import _build
from .ref import ssd_chunked

__all__ = ["ssd_scan", "ssd_scan_plain", "MAX_CHUNK", "MAX_STATE"]

MAX_CHUNK = 1024   # the kernel's in-block cumsum holds 4 steps a thread
MAX_STATE = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def _check(x, log_a, Bm, Cm, chunk: int, h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if log_a.shape != (b, s, h):
        raise ValueError(f"log_a must be {(b, s, h)}, got {tuple(log_a.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C must be (B, S, N) with B, S = {b}, {s}; got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    n = Bm.shape[2]
    if h0 is not None and h0.shape != (b, h, p, n):
        raise ValueError(f"h0 must be {(b, h, p, n)}, got {tuple(h0.shape)}")
    if s < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got S={s}, chunk={chunk}")
    tensors = [x, log_a, Bm, Cm] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K5's inputs lie on several devices")
    if x.device.type == "cuda":
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError("the CUDA K5 kernel takes float32 inputs")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA K5 kernel takes contiguous tensors")
        if chunk > MAX_CHUNK or n > MAX_STATE:
            raise ValueError(f"the CUDA K5 kernel takes chunk <= {MAX_CHUNK} and "
                             f"N <= {MAX_STATE}, got {chunk}, {n}")
    elif x.device.type != "cpu":
        raise ValueError(f"K5 runs on cpu or cuda, got {x.device}")


def ssd_scan_plain(x, log_a, Bm, Cm, *, chunk: int = 64,
                   h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain PyTorch version: the chunked algorithm in tensor ops."""
    return ssd_chunked(x, log_a, Bm, Cm, chunk, h0)


def ssd_scan(x, log_a, Bm, Cm, *, chunk: int = 64,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P), final state (B, H, P, N)) through K5, in float32."""
    _check(x, log_a, Bm, Cm, chunk, h0)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, log_a, Bm, Cm, chunk=chunk, h0=h0)
    b, s, h, p = x.shape
    n = Bm.shape[2]
    n_chunks = (s + chunk - 1) // chunk
    y = torch.empty_like(x)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # C·Bᵀ of every chunk, shared by all heads (scratch; lower triangle used)
    gram = torch.empty((b, n_chunks, chunk, chunk), dtype=torch.float32, device=x.device)
    launch = _build.function("ssd_scan", "ssd_scan_launch", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                     h_out.data_ptr(), gram.data_ptr(), b, s, h, p, n, chunk, stream)
    _build.check("ssd_scan", err, "ssd_scan launch")
    _build.count_launch(ssd_scan)
    return y, h_out


ssd_scan.launches = 0

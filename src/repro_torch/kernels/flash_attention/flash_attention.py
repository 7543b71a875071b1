"""Flash attention forward, K4: CUDA for Hopper, plain PyTorch beside.

The counterpart of ``repro.kernels.flash_attention.flash_attention``; the
CUDA source is ``repro_torch/csrc/flash_attention.cu``.
:func:`flash_attention` (K4) replaces ``flash_attention_pallas``: GQA
attention with an online softmax in float32, causal (top-left aligned:
query ``i`` sees keys ``j <= i``) and/or windowed (``j > i - window``)
masks, the output ``acc / max(l, 1e-30)`` in ``q``'s dtype.

:func:`flash_attention_plain` computes the same function densely with the
kernel's arithmetic: ``q`` scaled before the product, masked scores set
to ``-0.7 · FLT_MAX`` (not ``-inf``, so a fully masked row averages V as
the kernel does instead of giving NaN).  Any ``Sq`` and ``Sk`` reach the
kernel: it masks the ragged last tiles itself.

The wrapper takes the plain version for tensors on the CPU, launches the
kernel for CUDA tensors, and counts its launches in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build

__all__ = ["MASK_VALUE", "HEAD_DIMS", "flash_attention", "flash_attention_plain"]

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KVH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"K4 takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("K4's inputs lie on several devices")
    if q.device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"the CUDA K4 kernel takes head_dim in {HEAD_DIMS}, got {d}")
        if not all(t.is_contiguous() for t in (q, k, v)):
            raise ValueError("the CUDA K4 kernel takes contiguous tensors")
    elif q.device.type != "cpu":
        raise ValueError(f"K4 runs on cpu or cuda, got {q.device}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """K4's plain PyTorch version: one softmax over all keys at once."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, kvh, g, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())        # (B,KVH,G,Sq,Sk)
    if causal or window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= kp > qp - window
        s = s.masked_fill(~keep, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention forward through K4; returns (B, Sq, H, D) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = d**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    launch = _build.function("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, sk, h, kvh, d, _DTYPE_CODE[q.dtype], int(causal), int(window),
                     float(scale), stream)
    _build.check("flash_attention", err, "flash_attention launch")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0

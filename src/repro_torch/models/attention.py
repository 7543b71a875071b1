"""Attention: GQA with optional qk-norm, RoPE, local windows and a KV cache.

The port's copy of ``repro.models.attention`` for self-attention.  Two
paths, one math:

* prefill and training (``x`` of any length) — flash attention, K4
  (:func:`repro_torch.kernels.flash_attention.flash_attention`): the CUDA
  kernel for CUDA tensors at every length, its plain version for CPU
  tensors, or the plain version on any device when the caller passes
  ``plain=True``.  The reference runs this path through XLA
  (``_dense_attention`` / ``_chunked_attention``) and names its Pallas
  kernel as the TPU replacement; here the kernel is the path.
* decode (``x`` of one token and a cache) — plain torch ops, since no
  decode kernel exists: one query against the whole cache with a
  per-sequence validity mask.

Weights use the reference's fused 2-D layouts (wq: (d_model, H·hd)).  The
cache is written in place (the reference returns a new one): prefill and
decode return the same :class:`KVCache` object they were given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.flash_attention import (
    MASK_VALUE, flash_attention, flash_attention_plain,
)
from .layers import ParamBuilder, apply_rope, rms_norm

__all__ = ["attention_params", "KVCache", "init_kv_cache", "attention"]


def attention_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Q/K/V/O projections (+ qk-norm scales)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": b.param((d, qd)), "wk": b.param((d, kvd)), "wv": b.param((d, kvd)),
         "wo": b.param((qd, d))}
    if cfg.qk_norm:
        p["q_norm"] = b.param((cfg.head_dim,), init="zeros")
        p["k_norm"] = b.param((cfg.head_dim,), init="zeros")
    return p


@dataclasses.dataclass
class KVCache:
    """Fused-layout cache: k, v (B, S_cache, KVH·hd).  For windowed
    attention S_cache = window and writes wrap (rolling buffer).

    ``length`` (B,) int32 is per sequence: continuous batching refills one
    slot while its neighbours are mid-generation."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0, *,
                  device="cuda") -> KVCache:
    s = min(window, max_len) if window else max_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return KVCache(
        k=torch.zeros((batch, s, cfg.kv_dim), dtype=dt, device=device),
        v=torch.zeros((batch, s, cfg.kv_dim), dtype=dt, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _decode_attention(qg, cache: KVCache, k_new, v_new, cfg: ModelConfig, window: int):
    """One query per sequence against its cache; writes k_new/v_new first.

    A sequence whose write slot lies past the cache (a full cache without
    a window) keeps its cache unchanged, as the reference's out-of-bounds
    scatter drops the write.
    """
    b = qg.shape[0]
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    cache_len = cache.k.shape[1]
    length = cache.length.long()
    slot = length % cache_len if window else length
    in_range = (slot < cache_len)[:, None]
    idx = slot.clamp(max=cache_len - 1)
    rows = torch.arange(b, device=qg.device)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new.reshape(b, kvh * hd).to(buf.dtype)
        buf[rows, idx] = torch.where(in_range, new, buf[rows, idx])
    k_all = cache.k.reshape(b, cache_len, kvh, hd)
    v_all = cache.v.reshape(b, cache_len, kvh, hd)
    kp = torch.arange(cache_len, device=qg.device)[None, :]
    if window:
        valid = kp < torch.clamp(length + 1, max=cache_len)[:, None]
    else:
        valid = kp <= length[:, None]                                  # (B, Sk)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k_all.float()) * (hd**-0.5)
    scores = scores.masked_fill(~valid[:, None, None, None, :], MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    w = e / e.sum(dim=-1, keepdim=True)
    cache.length += 1
    return torch.einsum("bkgqs,bskh->bqkgh", w, v_all.float())


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                   # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    window: int = 0,
    cache: Optional[KVCache] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Causal self-attention (``window`` > 0 adds a local window).  Modes:

    * training/prefill: ``cache is None``, or a cache that prefill fills
      with the processed (post qk-norm, post-RoPE) keys and the values;
    * decode: ``x`` is (B, 1, d) and ``cache.length`` marks each write slot.

    ``plain=True`` runs the prefill through K4's plain version on any
    device (for comparisons); the default runs the kernel on the card.
    """
    b, s, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    decode = cache is not None and s == 1

    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    v_f = x @ p["wv"]
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = v_f.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if positions is None:
        if decode:
            positions = cache.length[:, None]
        else:
            positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    g = cfg.num_heads // max(kvh, 1)
    if decode:
        out = _decode_attention(q.reshape(b, s, kvh, g, hd), cache, k, v, cfg, window)
    else:
        if cache is not None:
            # prefill: fill the cache with the (window tail of the) processed K/V
            k_proc = k.reshape(b, s, kvh * hd)
            cache_len = cache.k.shape[1]
            if window and s > cache_len:
                # rolling layout: token t lives at slot t % window
                k_tail = torch.roll(k_proc[:, -cache_len:], s % cache_len, dims=1)
                v_tail = torch.roll(v_f[:, -cache_len:], s % cache_len, dims=1)
            elif s > cache_len:
                raise ValueError(f"a prompt of {s} tokens does not fit a cache of {cache_len}")
            else:
                k_tail, v_tail = k_proc, v_f
            cache.k[:, :k_tail.shape[1]] = k_tail.to(cache.k.dtype)
            cache.v[:, :v_tail.shape[1]] = v_tail.to(cache.v.dtype)
            cache.length.fill_(s)
        attend = flash_attention_plain if plain else flash_attention
        out = attend(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                     window=window, scale=hd**-0.5)

    out = out.reshape(b, s, cfg.q_dim).to(x.dtype)
    return out @ p["wo"], cache

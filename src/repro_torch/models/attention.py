"""Attention: GQA with optional qk-norm, RoPE, local windows, biases,
cross-attention and a KV cache.

The port's copy of ``repro.models.attention``.  Two paths, one math:

* prefill, training, the encoder and cross-attention (``x`` of any
  length, or any query against a cross source) — flash attention, K4
  (:func:`repro_torch.kernels.flash_attention.flash_attention`): the CUDA
  kernel for CUDA tensors at every length, its plain version for CPU
  tensors, or the plain version on any device when the caller passes
  ``plain=True``.  The reference runs this path through XLA
  (``_dense_attention`` / ``_chunked_attention``) and names its Pallas
  kernel as the TPU replacement; here the kernel is the path.  A cross
  query at decode (one token against the cached source keys) keeps the
  reference's branch structure: it is not the decode path, so it runs
  through K4 too, with ``Sq = 1`` and no mask.
* self-attention decode (``x`` of one token and a cache) — plain torch
  ops, since no decode kernel exists: one query against the whole cache
  with a per-sequence validity mask.

**On a model axis larger than 1** (``tp``: training, prefill and decode) the
layer is column-parallel over this rank's heads: ``wq`` (``qheads``) and
``wk`` / ``wv`` (``kvheads``) are the rank's blocks, K4 runs on the
local heads with the GQA ratio kept (tinyllama's 32 / 4 heads are 16 / 2
a rank on two ranks), and ``out @ wo`` (its rows, ``qheads``) leaves
through ``reduce_from`` (``scatter_seq`` under sequence parallelism)
before the bias.  The keys and values are computed whole, over every
kv head, and each rank reads the kv heads of its query heads, where the
rules do not split ``kvheads`` by whole heads:

* the split cuts a head (the fused ``kv_dim`` split by divisibility
  alone: recurrentgemma-9b's one kv head of 256 columns, the smoke
  config's of 8): ``wk``, ``wv``, ``bk`` and ``bv`` are gathered over
  ``model`` (their gradients reduce-scattered back);
* ``replicate_kv=True``, or a ``kv_dim`` that does not split: they are
  replicated, and enter the layer through ``TensorParallel.shared``.

``q_norm`` and ``k_norm`` (replicated, one scale for every head) enter
the same way.  A cross layer's source (whisper's encoder states, the
vision model's image embeddings) reaches it whole and replicated, as the
caller made it enter the region once for every layer.  Where the
rules' split of ``wq`` cuts a query head (40 heads on 16 ranks), or
does not split it, ``wq``, ``bq`` and ``wo`` are gathered too, every
rank computes every query head against every kv head, and the whole
product leaves through ``leave`` at ``1/size`` a rank
(:class:`HeadLayout` names a rank's heads).

A rank's caches hold the kv heads it attends with (``HeadLayout.kv``):
its block where ``kvheads`` splits by whole heads, the whole heads its
query heads read where the kv leaves are gathered or replicated, every
head where a query head is cut.  A cross cache holds them over the
whole source.

Weights use the reference's fused 2-D layouts (wq: (d_model, H·hd)).  The
cache is written in place (the reference returns a new one): prefill and
decode return the same :class:`KVCache` object they were given.  A cross
cache takes the source's keys and values (the raw projections, as in the
reference) at prefill, in place of its tensors, and is read at decode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.flash_attention import (
    MASK_VALUE, flash_attention, flash_attention_plain,
)
from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder, apply_rope, model_split, rms_norm

__all__ = ["attention_params", "KVCache", "init_kv_cache", "abstract_kv_cache",
           "kv_cache_specs", "HeadLayout", "head_layout", "attention"]


def attention_params(b: ParamBuilder, cfg: ModelConfig, *,
                     bias: bool = False) -> Dict[str, torch.Tensor]:
    """Q/K/V/O projections (+ biases, + qk-norm scales)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": b.param((d, qd), ("embed", "qheads")),
         "wk": b.param((d, kvd), ("embed", "kvheads")),
         "wv": b.param((d, kvd), ("embed", "kvheads")),
         "wo": b.param((qd, d), ("qheads", "embed"))}
    if bias:
        p.update(bq=b.param((qd,), ("qheads",), init="zeros"),
                 bk=b.param((kvd,), ("kvheads",), init="zeros"),
                 bv=b.param((kvd,), ("kvheads",), init="zeros"),
                 bo=b.param((d,), ("embed",), init="zeros"))
    if cfg.qk_norm:
        p["q_norm"] = b.param((cfg.head_dim,), ("heads_vec",), init="zeros")
        p["k_norm"] = b.param((cfg.head_dim,), ("heads_vec",), init="zeros")
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
                  device="cuda", tp: Optional[TensorParallel] = None) -> KVCache:
    """An empty cache; with ``tp``, of the kv heads this rank attends with."""
    s = min(window, max_len) if window else max_len
    width = cfg.kv_dim if tp is None or tp.size == 1 else len(head_layout(cfg, tp).kv) * \
        cfg.head_dim
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return KVCache(
        k=torch.zeros((batch, s, width), dtype=dt, device=device),
        v=torch.zeros((batch, s, width), dtype=dt, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def abstract_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0) -> KVCache:
    """:func:`init_kv_cache`'s cache as ``meta`` tensors."""
    return init_kv_cache(cfg, batch, max_len, window, device="meta")


def kv_cache_specs(cfg: ModelConfig, batch: int = 0, max_len: int = 0,
                   window: int = 0) -> KVCache:
    """The cache's logical axes (for the mesh rules), as the reference's."""
    return KVCache(k=("act_batch", None, "act_kv"), v=("act_batch", None, "act_kv"),
                   length=("act_batch",))


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """The heads one rank's attention computes on a model axis larger
    than 1: whether it computes every query head (``q_whole``: the split
    cuts one) and takes ``wk`` / ``wv`` whole (gathered or replicated),
    and the kv heads it attends with and caches, ``kv`` (global indices,
    in the order its attention reads them)."""

    q_whole: bool
    kv_whole: bool
    kv: Tuple[int, ...]


def head_layout(cfg: ModelConfig, tp: TensorParallel) -> HeadLayout:
    """The :class:`HeadLayout` of this model rank."""
    first, count = tp.heads(cfg.num_heads)
    kvh = cfg.num_kv_heads
    if count == cfg.num_heads:                 # a cut (or unsplit) query head: every head
        return HeadLayout(True, True, tuple(range(kvh)))
    if model_split(tp, attention_params, cfg)["wk"] is not None and kvh % tp.size == 0:
        per = kvh // tp.size                   # this rank's kv heads, GQA ratio kept
        return HeadLayout(False, False, tuple(range(tp.rank * per, (tp.rank + 1) * per)))
    g = cfg.num_heads // kvh
    idx = [(first + i) // g for i in range(count)]
    lo, hi = idx[0], idx[-1] + 1
    per = count // (hi - lo)
    if per * (hi - lo) == count and idx == [lo + i // per for i in range(count)]:
        return HeadLayout(False, True, tuple(range(lo, hi)))    # whole kv heads, ratio per
    return HeadLayout(False, True, tuple(idx))                  # one kv head a query head


def _decode_attention(qg, cache: KVCache, k_new, v_new, window: int):
    """One query per sequence against its cache; writes k_new/v_new first.

    A sequence whose write slot lies past the cache (a full cache without
    a window) keeps its cache unchanged, as the reference's out-of-bounds
    scatter drops the write.  The kv heads are ``k_new``'s (this rank's
    on a model axis larger than 1).
    """
    b = qg.shape[0]
    kvh, hd = k_new.shape[2], k_new.shape[3]
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
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    cache: Optional[KVCache] = None,
    cache_update: bool = True,
    plain: bool = False,
    tp: Optional[TensorParallel] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention (``causal``, and a local window when ``window`` > 0)
    or cross-attention.  Modes:

    * training/prefill: ``cache is None``, or a cache that prefill fills
      with the processed (post qk-norm, post-RoPE) keys and the values;
    * decode: ``x`` is (B, 1, d) and ``cache.length`` marks each write slot;
    * cross: ``kv_x`` given ⇒ no mask and no RoPE; with a cache, prefill
      (``cache_update=True``) stores ``kv_x``'s keys and values, and
      ``cache_update=False`` attends the cached ones (``kv_x`` is then
      only the flag).

    ``plain=True`` runs K4's plain version on any device (for
    comparisons); the default runs the kernel on the card.  ``tp`` (a
    model axis larger than 1) runs this rank's heads; ``x`` is then in
    the residual stream's layout, ``kv_x`` whole and ``cache`` this
    rank's (:func:`init_kv_cache` with ``tp``).
    """
    split = tp is not None and tp.size > 1
    if split:
        x = tp.enter(x)
        p, layout = _local_weights(p, cfg, tp)
    b, s, _ = x.shape
    hd = cfg.head_dim
    nh, kvh = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    is_cross = kv_x is not None
    decode = cache is not None and s == 1 and not is_cross
    reuse_cross = is_cross and cache is not None and not cache_update

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, nh, hd)
    if reuse_cross:
        k_f, v_f = cache.k, cache.v
        kvh = cache.k.shape[-1] // hd
    else:
        src = kv_x if is_cross else x
        k_f, v_f = src @ p["wk"], src @ p["wv"]
        if "bk" in p:
            k_f, v_f = k_f + p["bk"], v_f + p["bv"]
    k = k_f.reshape(b, -1, kvh, hd)
    v = v_f.reshape(b, -1, kvh, hd)
    if split and layout.kv_whole and not reuse_cross and layout.kv != tuple(range(kvh)):
        heads = _index(layout.kv)          # whole kv: the heads of this rank's queries
        k, v = k[:, :, heads], v[:, :, heads]
        kvh = k.shape[2]
    if is_cross and cache is not None and cache_update:
        # the source's keys and values (the raw projections, as in the reference)
        cache.k = k.reshape(b, -1, kvh * hd).to(cache.k.dtype)
        cache.v = v.reshape(b, -1, kvh * hd).to(cache.v.dtype)
        cache.length.fill_(k.shape[1])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if not reuse_cross:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if positions is None:
        if decode:
            positions = cache.length[:, None]
        else:
            positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta and not is_cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    g = nh // max(kvh, 1)
    if decode:
        out = _decode_attention(q.reshape(b, s, kvh, g, hd), cache, k, v, window)
    else:
        if cache is not None and not is_cross and cache_update:
            # prefill: fill the cache with the (window tail of the) processed K/V
            k_proc, v_proc = k.reshape(b, s, kvh * hd), v.reshape(b, s, kvh * hd)
            cache_len = cache.k.shape[1]
            if window and s > cache_len:
                # rolling layout: token t lives at slot t % window
                k_tail = torch.roll(k_proc[:, -cache_len:], s % cache_len, dims=1)
                v_tail = torch.roll(v_proc[:, -cache_len:], s % cache_len, dims=1)
            elif s > cache_len:
                raise ValueError(f"a prompt of {s} tokens does not fit a cache of {cache_len}")
            else:
                k_tail, v_tail = k_proc, v_proc
            cache.k[:, :k_tail.shape[1]] = k_tail.to(cache.k.dtype)
            cache.v[:, :v_tail.shape[1]] = v_tail.to(cache.v.dtype)
            cache.length.fill_(s)
        attend = flash_attention_plain if plain else flash_attention
        out = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal and not is_cross, window=window, scale=hd**-0.5)

    out = out.reshape(b, s, nh * hd).to(x.dtype)
    y = out @ p["wo"]
    if split:   # a whole product is every rank's: each hands on 1/size of it
        y = tp.leave(y / tp.size if layout.q_whole else y)
    if "bo" in p:
        y = y + p["bo"]
    return y, cache


def _index(heads: Tuple[int, ...]):
    """``heads`` as an index of a head dim: a slice where they run in order."""
    lo = heads[0]
    return slice(lo, lo + len(heads)) if heads == tuple(range(lo, lo + len(heads))) \
        else torch.tensor(heads)


def _local_weights(p: Dict[str, torch.Tensor], cfg: ModelConfig, tp: TensorParallel):
    """(this rank's attention weights, its :class:`HeadLayout`): the
    blocks of its heads, with the leaves it needs whole gathered."""
    layout = head_layout(cfg, tp)
    dims = model_split(tp, attention_params, cfg, bias="bk" in p)
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = tp.shared(p[name])
    whole = (("wq", "bq", "wo") if layout.q_whole else ()) + \
        (("wk", "wv", "bk", "bv") if layout.kv_whole else ())
    for name in whole:
        if name in p:
            p[name] = tp.full(p[name], dims[name])
    return p, layout

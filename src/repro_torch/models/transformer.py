"""Decoder-only transformer supporting every decoder family.

The port's copy of ``repro.models.transformer``:

  dense   ("attn",) × L   (tinyllama, llama3.2, qwen3, stablelm)
  moe     ("moe",)  × L   (qwen3-moe, grok-1)
  ssm     ("ssd",)  × L   (mamba2)
  hybrid  ("rglru", "rglru", "attn") × 12 + remainder ("rglru", "rglru")
          (recurrentgemma; local attention over ``cfg.window``, Gemma's
          embedding scale √d_model)
  vlm     ("attn",) × 4 + ("cross",), repeated (llama-3.2-vision)

(whisper's encoder and decoder stacks live in ``encdec.py`` and reuse
these blocks.)  The reference stacks each pattern position's parameters
on a leading layer dim and scans over them; PyTorch runs eagerly, so the
port keeps one parameter dict and one cache per layer, in layer order,
and loops.  A ``moe`` block is an ``attn`` block whose FFN is
:func:`~.moe.moe_ffn`; its aux values (``AUX_KEYS``, summed over layers)
reach a caller that passes an ``aux`` dict to :func:`decoder_forward`.  A
``cross`` block is an ``attn`` block with a gated cross-attention to
``image_embeds`` and a gated FFN; its cache is ``{"self": KVCache,
"cross": KVCache}``.  A training forward with grad enabled checkpoints
each repetition of the pattern (:func:`remat_enabled`), the unit the
reference's ``jax.checkpoint`` wraps; the remainder's layers are not
checkpointed, as in the reference.

On a mesh (``tp``: training, prefill, decode) every block runs its own
tensor-parallel form (its module says which), and the embedding is vocab-parallel:
``embed`` holds this rank's rows of the vocabulary, each rank looks its
tokens up there with the others' set to zero, and the sum leaves
through ``reduce_from`` (``scatter_seq`` under sequence parallelism,
where the residual stream holds this rank's block of positions); the
hybrid's embedding scale follows the lookup.  The norms are replicated
and run on the residual stream as it is.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..configs.base import ModelConfig
from .attention import attention, attention_params, init_kv_cache, kv_cache_specs
from .ffn import ffn, ffn_params
from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder, rms_norm
from .moe import moe_ffn, moe_params
from .rglru import init_rglru_state, rglru_block, rglru_params, rglru_state_specs
from .ssm import init_ssm_state, ssd_block, ssd_params, ssm_state_specs

__all__ = ["AUX_KEYS", "pattern_of", "layer_kinds", "build_decoder_params",
           "init_caches", "abstract_caches", "cache_specs", "remat_enabled", "embed_lookup",
           "decoder_forward", "lm_logits"]

AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_overflow_frac", "moe_load_max")


def pattern_of(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repeats, remainder), as in the reference."""
    if cfg.family == "dense":
        pat: Tuple[str, ...] = ("attn",)
    elif cfg.family == "moe":
        pat = ("moe",)
    elif cfg.family == "ssm":
        pat = ("ssd",)
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")
    elif cfg.family == "vlm":
        ce = cfg.cross_attn_every or 5
        pat = ("attn",) * (ce - 1) + ("cross",)
    else:
        raise ValueError(f"pattern_of: unsupported family {cfg.family}")
    repeats, rem = divmod(cfg.num_layers, len(pat))
    return pat, repeats, pat[:rem]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer in order: the pattern repeated, then the remainder."""
    pat, repeats, rem = pattern_of(cfg)
    return list(pat) * repeats + list(rem)


def _block_params(b: ParamBuilder, cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == "attn":
        return {
            "ln_attn": b.param((d,), ("embed",), init="zeros"),
            "attn": attention_params(b, cfg),
            "ln_mlp": b.param((d,), ("embed",), init="zeros"),
            "mlp": ffn_params(b, d, cfg.d_ff),
        }
    if kind == "moe":
        return {
            "ln_attn": b.param((d,), ("embed",), init="zeros"),
            "attn": attention_params(b, cfg),
            "ln_mlp": b.param((d,), ("embed",), init="zeros"),
            "moe": moe_params(b, cfg),
        }
    if kind == "ssd":
        return {"ln": b.param((d,), ("embed",), init="zeros"), "ssd": ssd_params(b, cfg)}
    if kind == "rglru":
        return {
            "ln_rec": b.param((d,), ("embed",), init="zeros"),
            "rec": rglru_params(b, cfg),
            "ln_mlp": b.param((d,), ("embed",), init="zeros"),
            "mlp": ffn_params(b, d, cfg.d_ff),
        }
    if kind == "cross":
        return {
            "ln_attn": b.param((d,), ("embed",), init="zeros"),
            "attn": attention_params(b, cfg),
            "ln_xattn": b.param((d,), ("embed",), init="zeros"),
            "xattn": attention_params(b, cfg),
            "gate_attn": b.param((), (), init="zeros"),
            "ln_mlp": b.param((d,), ("embed",), init="zeros"),
            "mlp": ffn_params(b, d, cfg.d_ff),
            "gate_mlp": b.param((), (), init="zeros"),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def build_decoder_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    # vocab-only sharding of the table, as the reference's
    params: Dict[str, Any] = {"embed": b.param((v, d), ("vocab", None), scale=0.02)}
    params["layers"] = [_block_params(b, cfg, kind) for kind in layer_kinds(cfg)]
    params["final_norm"] = b.param((d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        params["lm_head"] = b.param((d, v), ("embed", "vocab"), scale=0.02)
    return params


def _window(cfg: ModelConfig) -> int:
    """The local attention window: ``cfg.window`` for the hybrid family only."""
    return cfg.window if cfg.family == "hybrid" else 0


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
                tp: Optional[TensorParallel] = None) -> List[Any]:
    """One cache per layer: a KVCache for attention (``attn``, ``moe``;
    window-sized for the hybrid family), an SSMState for SSD, an
    RGLRUState for RG-LRU, and ``{"self", "cross"}`` KVCaches for
    ``cross`` (the cross one holds ``num_image_tokens`` rows).  With
    ``tp``, each holds what this model rank computes with (its kv heads,
    its RG-LRU features; the SSD state whole)."""
    caches: List[Any] = []
    for kind in layer_kinds(cfg):
        if kind in ("attn", "moe"):
            caches.append(init_kv_cache(cfg, batch, max_len, _window(cfg), device=device, tp=tp))
        elif kind == "ssd":
            caches.append(init_ssm_state(cfg, batch, device=device))
        elif kind == "rglru":
            caches.append(init_rglru_state(cfg, batch, device=device, tp=tp))
        else:
            caches.append({"self": init_kv_cache(cfg, batch, max_len, device=device, tp=tp),
                           "cross": init_kv_cache(cfg, batch, cfg.num_image_tokens,
                                                  device=device, tp=tp)})
    return caches


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> List[Any]:
    """:func:`init_caches`'s list as ``meta`` tensors: the reference's
    ``abstract_caches`` unstacked, one cache per layer in layer order."""
    return init_caches(cfg, batch, max_len, device="meta")


def cache_specs(cfg: ModelConfig, batch: int = 0, max_len: int = 0) -> List[Any]:
    """Each layer's cache with its leaves' logical axes in their place:
    the reference's ``cache_specs`` without the stacked layer dim."""
    specs: List[Any] = []
    for kind in layer_kinds(cfg):
        if kind in ("attn", "moe"):
            specs.append(kv_cache_specs(cfg))
        elif kind == "ssd":
            specs.append(ssm_state_specs(cfg))
        elif kind == "rglru":
            specs.append(rglru_state_specs(cfg))
        else:
            specs.append({"self": kv_cache_specs(cfg), "cross": kv_cache_specs(cfg)})
    return specs


def _apply_block(kind: str, p, x, cfg: ModelConfig, *, mode: str, positions, cache,
                 image_embeds, plain, tp: Optional[TensorParallel] = None):
    """One block -> (x, aux values); its cache (if any) is updated in place."""
    decode = mode == "decode"
    if kind in ("attn", "moe"):
        h, _ = attention(p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps), cfg,
                         positions=positions, window=_window(cfg), cache=cache, plain=plain,
                         tp=tp)
        x = x + h
        if kind == "attn":
            return x + ffn(p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps), tp), {}
        h, aux = moe_ffn(p["moe"], rms_norm(x, p["ln_mlp"], cfg.norm_eps), cfg, tp)
        return x + h, aux
    if kind == "ssd":
        h, _ = ssd_block(p["ssd"], rms_norm(x, p["ln"], cfg.norm_eps), cfg, state=cache,
                         decode=decode, plain=plain, tp=tp)
        return x + h, {}
    if kind == "rglru":
        h, _ = rglru_block(p["rec"], rms_norm(x, p["ln_rec"], cfg.norm_eps), cfg, state=cache,
                           decode=decode, plain=plain, tp=tp)
        x = x + h
        return x + ffn(p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps), tp), {}
    # cross: self-attention, then gated cross-attention and a gated FFN
    h, _ = attention(p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps), cfg,
                     positions=positions, cache=cache["self"] if cache is not None else None,
                     plain=plain, tp=tp)
    x = x + h
    h, _ = attention(p["xattn"], rms_norm(x, p["ln_xattn"], cfg.norm_eps), cfg,
                     kv_x=image_embeds, causal=False,
                     cache=cache["cross"] if cache is not None else None,
                     cache_update=not decode, plain=plain, tp=tp)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * ffn(
        p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps), tp), {}


def remat_enabled(cfg: ModelConfig, mode: str) -> bool:
    """Whether a forward checkpoints its units (``torch.utils.checkpoint``):
    a training forward with grad enabled and ``cfg.parallel.remat`` other
    than "none", as the reference's ``jax.checkpoint`` of each unit."""
    return mode == "train" and torch.is_grad_enabled() and cfg.parallel.remat != "none"


def decoder_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                 # (B, S) int
    cfg: ModelConfig,
    *,
    mode: str = "train",                  # "train" | "prefill" | "decode"
    positions: Optional[torch.Tensor] = None,
    caches: Optional[List[Any]] = None,
    image_embeds: Optional[torch.Tensor] = None,   # (B, n_img, d): the vlm's cross source
    plain: bool = False,
    aux: Optional[Dict[str, torch.Tensor]] = None,
    tp: Optional[TensorParallel] = None,
) -> Tuple[torch.Tensor, Optional[List[Any]]]:
    """Returns (final hidden (B, S, d), caches updated in place).

    ``aux``, when given, receives the ``AUX_KEYS`` values summed over the
    layers as float32 scalars (zeros for a model without ``moe`` blocks),
    as the reference's third return value.  With ``tp`` the hidden state
    is in the residual stream's layout (this rank's positions under
    sequence parallelism).
    """
    x = embed_lookup(params["embed"], tokens, tp)
    if cfg.family == "hybrid":  # gemma-style embedding scale
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if aux is not None:
        aux.update({key: torch.zeros((), dtype=torch.float32, device=x.device)
                    for key in AUX_KEYS})
    kinds = layer_kinds(cfg)
    # each block's backward as a span: remat's re-run of a block (this
    # ``run`` again, inside the backward) falls inside it
    chain = tracing.BackwardChain() if tracing.enabled() else None

    def run(x, lo: int, hi: int):
        """Layers [lo, hi) -> (x, each layer's aux values)."""
        auxes = []
        for i in range(lo, hi):
            if chain is not None:
                chain.layer(i, f"block.{kinds[i]}.backward", x)
            with tracing.span(f"block.{kinds[i]}"):
                x, block_aux = _apply_block(kinds[i], params["layers"][i], x, cfg, mode=mode,
                                            positions=positions,
                                            cache=caches[i] if caches is not None else None,
                                            image_embeds=image_embeds, plain=plain, tp=tp)
            auxes.append(block_aux)
        return x, auxes

    # the reference's units: one per repetition of the pattern (checkpointed
    # under remat), then the remainder's layers one by one (never)
    pat, repeats, _ = pattern_of(cfg)
    n = len(pat)
    units = [(r * n, (r + 1) * n, True) for r in range(repeats)]
    units += [(i, i + 1, False) for i in range(repeats * n, len(kinds))]
    remat = remat_enabled(cfg, mode)
    for lo, hi, stacked in units:
        if remat and stacked:
            x, auxes = checkpoint(run, x, lo, hi, use_reentrant=False)
        else:
            x, auxes = run(x, lo, hi)
        if aux is not None:
            for block_aux in auxes:
                for key, value in block_aux.items():
                    aux[key] = aux[key] + value.float()
    if chain is not None:
        chain.end(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """The rows of ``tokens``; with ``tp``, ``table`` is this rank's block
    of the vocabulary and the lookup is vocab-parallel."""
    if tp is None or tp.size == 1:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return tp.leave(x)


def lm_logits(params: Dict[str, Any], hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]

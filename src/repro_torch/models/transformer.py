"""Decoder-only transformer: the ``dense`` and ``ssm`` patterns.

The port's copy of ``repro.models.transformer`` for the two families the
serving slice runs:

  dense   ("attn",) × L   (tinyllama, llama3.2, qwen3, stablelm)
  ssm     ("ssd",)  × L   (mamba2)

The reference stacks each pattern position's parameters on a leading
layer dim and scans over them; PyTorch runs eagerly, so the port keeps one
parameter dict and one cache per layer, in layer order, and loops.  The
``moe``, ``rglru`` and ``cross`` block kinds (and so the ``moe``,
``hybrid``, ``vlm`` and ``encdec`` families) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import attention, attention_params, init_kv_cache
from .ffn import ffn, ffn_params
from .layers import ParamBuilder, rms_norm
from .ssm import init_ssm_state, ssd_block, ssd_params

__all__ = ["NOT_PORTED", "pattern_of", "layer_kinds", "build_decoder_params", "init_caches",
           "decoder_forward", "lm_logits"]

# family or block kind -> the ROADMAP.md item that ports it
NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 10 (models/moe.py)",
    "hybrid": "ROADMAP.md queue 1 item 10 (models/rglru.py)",
    "rglru": "ROADMAP.md queue 1 item 10 (models/rglru.py)",
    "encdec": "ROADMAP.md queue 1 item 10 (models/encdec.py)",
    "vlm": "ROADMAP.md queue 1 item 10 (the VLM cross-attention path)",
    "cross": "ROADMAP.md queue 1 item 10 (the VLM cross-attention path)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what!r} is not ported to PyTorch yet: {NOT_PORTED[what]}")


def pattern_of(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repeats, remainder), as in the reference."""
    if cfg.family == "dense":
        pat: Tuple[str, ...] = ("attn",)
    elif cfg.family == "ssm":
        pat = ("ssd",)
    elif cfg.family in NOT_PORTED:
        raise _not_ported(cfg.family)
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
            "ln_attn": b.param((d,), init="zeros"),
            "attn": attention_params(b, cfg),
            "ln_mlp": b.param((d,), init="zeros"),
            "mlp": ffn_params(b, d, cfg.d_ff),
        }
    if kind == "ssd":
        return {"ln": b.param((d,), init="zeros"), "ssd": ssd_params(b, cfg)}
    if kind in NOT_PORTED:
        raise _not_ported(kind)
    raise ValueError(f"unknown block kind {kind!r}")


def build_decoder_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    params: Dict[str, Any] = {"embed": b.param((v, d), scale=0.02)}
    params["layers"] = [_block_params(b, cfg, kind) for kind in layer_kinds(cfg)]
    params["final_norm"] = b.param((d,), init="zeros")
    if not cfg.tie_embeddings:
        params["lm_head"] = b.param((d, v), scale=0.02)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> List[Any]:
    """One cache per layer: a KVCache for attention, an SSMState for SSD."""
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "attn":
            caches.append(init_kv_cache(cfg, batch, max_len, device=device))
        else:
            caches.append(init_ssm_state(cfg, batch, device=device))
    return caches


def _apply_block(kind: str, p, x, cfg: ModelConfig, *, mode: str, positions, cache, plain):
    """One block; its cache (if any) is updated in place."""
    if kind == "attn":
        h, _ = attention(p["attn"], rms_norm(x, p["ln_attn"], cfg.norm_eps), cfg,
                         positions=positions, cache=cache, plain=plain)
        x = x + h
        return x + ffn(p["mlp"], rms_norm(x, p["ln_mlp"], cfg.norm_eps))
    h, _ = ssd_block(p["ssd"], rms_norm(x, p["ln"], cfg.norm_eps), cfg, state=cache,
                     decode=mode == "decode", plain=plain)
    return x + h


def decoder_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                 # (B, S) int
    cfg: ModelConfig,
    *,
    mode: str = "train",                  # "train" | "prefill" | "decode"
    positions: Optional[torch.Tensor] = None,
    caches: Optional[List[Any]] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Any]]]:
    """Returns (final hidden (B, S, d), caches updated in place)."""
    x = params["embed"][tokens.long()]
    for i, kind in enumerate(layer_kinds(cfg)):
        x = _apply_block(kind, params["layers"][i], x, cfg, mode=mode, positions=positions,
                         cache=caches[i] if caches is not None else None, plain=plain)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def lm_logits(params: Dict[str, Any], hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]

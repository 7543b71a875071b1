"""Whisper-style encoder–decoder backbone (arXiv:2212.04356).

The port's copy of ``repro.models.encdec``.  As in the reference, the conv
frontend is a stub: the model takes precomputed frame embeddings
(B, S_enc, d_model).  LayerNorm, biased projections and GELU MLPs
(whisper's convention), sinusoidal encoder positions, learned decoder
positions (``dec_pos``, 32768 × d), no RoPE.

The encoder attends without a mask and the decoder's self-attention is
causal, both through K4; the decoder's cross-attention reads the encoder
states at prefill and the cross caches at decode (one query per step
through K4).  The reference stacks the layers' parameters and scans; the
port keeps per-layer lists (``enc_blocks``, ``dec_blocks``) and loops, and
each decoder layer's cache is ``{"self": KVCache, "cross": KVCache}``.
A training forward with grad enabled checkpoints each encoder and each
decoder block, the units the reference's ``jax.checkpoint`` wraps.

On a mesh (``tp``: training, prefill, decode) the blocks are tensor-parallel as the
decoder family's (attention over this rank's heads, the GELU MLP over
its block of ``mlp``), the token embedding is vocab-parallel, and under
sequence parallelism the encoder's and decoder's residual streams hold
this rank's block of positions (the frames and ``dec_pos`` are sliced to
it).  The encoder states enter the decoder's cross-attention once, whole
and replicated, for every layer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import attention, attention_params, init_kv_cache, kv_cache_specs
from .ffn import gelu_ffn, gelu_ffn_params
from ..parallel.tensor_parallel import TensorParallel
from .layers import ParamBuilder, layer_norm, sinusoidal_positions
from .transformer import embed_lookup, remat_enabled

__all__ = ["MAX_DECODER_POS", "build_encdec_params", "encoder_forward", "init_encdec_caches",
           "abstract_encdec_caches", "encdec_cache_specs", "decoder_forward_encdec"]

MAX_DECODER_POS = 32768


def _ln_params(b: ParamBuilder, d: int) -> Dict[str, torch.Tensor]:
    return {"w": b.param((d,), ("embed",), init="ones"),
            "b": b.param((d,), ("embed",), init="zeros")}


def _enc_block_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln_attn": _ln_params(b, d),
        "attn": attention_params(b, cfg, bias=True),
        "ln_mlp": _ln_params(b, d),
        "mlp": gelu_ffn_params(b, d, cfg.d_ff),
    }


def _dec_block_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln_attn": _ln_params(b, d),
        "attn": attention_params(b, cfg, bias=True),
        "ln_xattn": _ln_params(b, d),
        "xattn": attention_params(b, cfg, bias=True),
        "ln_mlp": _ln_params(b, d),
        "mlp": gelu_ffn_params(b, d, cfg.d_ff),
    }


def build_encdec_params(b: ParamBuilder, cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": b.param((v, d), ("vocab", None), scale=0.02),
        "dec_pos": b.param((MAX_DECODER_POS, d), (None, "embed"), scale=0.01),
        "enc_blocks": [_enc_block_params(b, cfg) for _ in range(cfg.encoder_layers)],
        "enc_ln_out": _ln_params(b, d),
        "dec_blocks": [_dec_block_params(b, cfg) for _ in range(cfg.num_layers)],
        "dec_ln_out": _ln_params(b, d),
    }


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def _positions_block(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x``'s block of positions that this rank's residual stream holds."""
    return x[:, tp.block(x.shape[1])] if tp is not None and tp.sp else x


def encoder_forward(params: Dict[str, Any], frames: torch.Tensor, cfg: ModelConfig, *,
                    plain: bool = False, remat: bool = False,
                    tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings → encoder states (B, S_enc, d)
    (with ``tp``, in the residual stream's layout).  ``remat`` checkpoints
    each block (the training forward's choice)."""
    s, d = frames.shape[1], frames.shape[2]
    x = frames + sinusoidal_positions(s, d, device=frames.device).to(frames.dtype)[None]
    x = _positions_block(x, tp)

    def block(x, p):
        h, _ = attention(p["attn"], _ln(x, p["ln_attn"], cfg), cfg, causal=False, plain=plain,
                         tp=tp)
        x = x + h
        return x + gelu_ffn(p["mlp"], _ln(x, p["ln_mlp"], cfg), tp)

    for p in params["enc_blocks"]:
        x = checkpoint(block, x, p, use_reentrant=False) if remat else block(x, p)
    return _ln(x, params["enc_ln_out"], cfg)


def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *,
                       device="cuda", tp: Optional[TensorParallel] = None
                       ) -> List[Dict[str, Any]]:
    """Per decoder layer: a self cache of ``max_len`` rows and a cross
    cache of ``enc_len`` rows (with ``tp``, of this rank's kv heads)."""
    return [{"self": init_kv_cache(cfg, batch, max_len, device=device, tp=tp),
             "cross": init_kv_cache(cfg, batch, enc_len, device=device, tp=tp)}
            for _ in range(cfg.num_layers)]


def abstract_encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                           enc_len: int) -> List[Dict[str, Any]]:
    """:func:`init_encdec_caches`'s list as ``meta`` tensors."""
    return init_encdec_caches(cfg, batch, max_len, enc_len, device="meta")


def encdec_cache_specs(cfg: ModelConfig, batch: int = 0, max_len: int = 0,
                       enc_len: int = 0) -> List[Dict[str, Any]]:
    """Each decoder layer's caches with their leaves' logical axes in
    their place: the reference's ``encdec_cache_specs`` unstacked."""
    return [{"self": kv_cache_specs(cfg), "cross": kv_cache_specs(cfg)}
            for _ in range(cfg.num_layers)]


def decoder_forward_encdec(
    params: Dict[str, Any],
    tokens: torch.Tensor,                 # (B, S)
    enc_out: torch.Tensor,                # (B, S_enc, d); at decode only the cross flag
    cfg: ModelConfig,
    *,
    mode: str = "train",
    positions: Optional[torch.Tensor] = None,
    caches: Optional[List[Dict[str, Any]]] = None,
    plain: bool = False,
    tp: Optional[TensorParallel] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]]]:
    """Returns (final hidden (B, S, d), caches updated in place).  With
    ``tp``, ``enc_out`` is whole and replicated (the caller made it enter
    the model group once) and the hidden state is in the residual
    stream's layout."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, tp)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    pos_emb = params["dec_pos"][positions.reshape(-1).long()].reshape(
        b if positions.shape[0] == b else 1, s, -1)
    x = x + _positions_block(pos_emb, tp).to(x.dtype)
    decode = mode == "decode"

    def block(x, p, cache):
        h, _ = attention(p["attn"], _ln(x, p["ln_attn"], cfg), cfg, positions=positions,
                         cache=cache["self"] if cache is not None else None, plain=plain,
                         tp=tp)
        x = x + h
        h, _ = attention(p["xattn"], _ln(x, p["ln_xattn"], cfg), cfg, kv_x=enc_out,
                         causal=False, cache=cache["cross"] if cache is not None else None,
                         cache_update=not decode, plain=plain, tp=tp)
        x = x + h
        return x + gelu_ffn(p["mlp"], _ln(x, p["ln_mlp"], cfg), tp)

    remat = remat_enabled(cfg, mode)
    for i, p in enumerate(params["dec_blocks"]):
        cache = caches[i] if caches is not None else None
        x = checkpoint(block, x, p, cache, use_reentrant=False) if remat else block(x, p, cache)
    return _ln(x, params["dec_ln_out"], cfg), caches

"""Model configurations (the port's copy of ``repro.configs.base``).

Every assigned architecture is a :class:`ModelConfig`, its distribution
knobs a :class:`ParallelConfig`, with the reference's fields and
defaults, a training or serving batch an :class:`InputShape`, the
benchmark shapes :data:`SHAPES`, and the pairing rule of an arch and a
shape :func:`cell_status`.  The port reads ``capacity_factor`` and
``moe_fallback`` (``models/moe.py``); the trainer reads ``remat``
(``models/transformer.py``, ``models/encdec.py``), ``microbatches``,
``opt_state_dtype`` and ``grad_accum_dtype`` (``launch/``); the mesh
rules (``parallel/mesh_rules.py``) read ``fsdp``, ``tensor_parallel``,
``replicate_kv`` and ``sequence_parallel``.  ``param_count`` and
``active_param_count`` give the 6·N·tokens model flops of a training
step.

Config data that nothing reads, kept because the reference keeps it:
``grad_reduce``, ``grad_compression`` and ``pipeline_stages`` (nothing
in the reference reads them either: ``parallel/collectives.py`` and
``parallel/pipeline.py`` are library functions) and ``scan_layers`` (the
port keeps one parameter dict per layer and has no ``lax.scan``).
``moe_dispatch`` is read by ``models/moe.py`` on a mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = ["ModelConfig", "InputShape", "ParallelConfig", "SHAPES", "cell_status", "VOCAB_PAD"]

VOCAB_PAD = 256  # vocab padded to a multiple of this (TP divisibility)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution knobs, with the reference's fields and defaults."""

    fsdp: bool = True                  # shard weights over "data" (ZeRO-3)
    tensor_parallel: bool = True       # shard heads/ffn/vocab over "model"
    sequence_parallel: bool = False    # Megatron-SP activation sharding
    pipeline_stages: int = 1           # >1 => pipeline over "pod" (read by nothing)
    remat: str = "block"               # "none" | "block" | "full"
    grad_reduce: str = "reduce_scatter"  # "all_reduce" | "reduce_scatter" (read by nothing)
    grad_compression: bool = False     # int8 error-feedback DP compression (read by nothing)
    microbatches: int = 1              # grad-accum chunks (ENEAC iteration space)
    opt_state_dtype: str = "float32"   # "bfloat16" halves AdamW memory
    moe_dispatch: str = "gspmd"        # "gspmd" (global) | "local" (per-shard routing;
                                       # on one device the global path, as in the reference)
    grad_accum_dtype: str = "float32"  # bf16 halves the grad-accum resident
    replicate_kv: bool = False         # replicate K/V projections instead of sharding
                                       # the fused kv_dim across head boundaries
    scan_layers: bool = True           # the reference's lax.scan over block groups
                                       # (read by nothing: the port loops over layers)
    moe_fallback: bool = True          # ENEAC dense fallback (False = drop overflow)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture (exact dims from the assignment table)."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 ⇒ d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 ⇒ d_ff)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    window: int = 0                        # local attention window
    lru_width: int = 0                     # 0 ⇒ d_model

    # --- enc-dec (Whisper backbone) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500     # nominal frame count (stub frontend)

    # --- VLM ---
    cross_attn_every: int = 0   # cross-attn block every N layers
    num_image_tokens: int = 1024

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context?  SSM state is O(1);
        RG-LRU + windowed local attention is O(window).  Everything else
        holds a dense KV cache with full attention."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    # -- parameter count (for 6ND and memory estimates) --------------------
    def param_count(self) -> int:
        d, L, V = self.d_model, self.num_layers, self.padded_vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D + norm
            per = d * (2 * di + 2 * st + nh) + self.conv_width * (di + 2 * st) \
                + di * d + 2 * nh + di + d
            return emb + L * per + d
        att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qk_norm:
            att += 2 * self.head_dim
        dense_ffn = 3 * d * self.d_ff  # SwiGLU
        norms = 2 * d
        if self.family == "moe":
            eff = self.moe_d_ff or self.d_ff
            moe = self.num_experts * 3 * d * eff + d * self.num_experts
            if self.parallel.moe_fallback:
                moe += 3 * d * eff  # shared fallback FFN (the CC path)
            per = att + moe + norms
        elif self.family == "hybrid":
            # pattern mix of rglru + local-attn blocks
            lw = self.lru_width or d
            rglru = d * 2 * lw + lw * d + self.conv_width * lw + 3 * lw \
                + lw * 2 * lw // 8  # gates (block-diagonal, 8 blocks)
            n_attn = self.attn_layer_count()
            n_rec = self.num_layers - n_attn
            total = n_attn * (att + dense_ffn + norms) + n_rec * (rglru + dense_ffn + norms)
            return emb + total + d
        elif self.family == "encdec":
            # decoder layers have an extra cross-attention
            enc_per = att + dense_ffn + norms
            dec_per = 2 * att + dense_ffn + 3 * d
            return emb + self.encoder_layers * enc_per + L * dec_per + 2 * d
        elif self.family == "vlm":
            n_cross = self.cross_attn_layer_count()
            n_self = self.num_layers - n_cross
            cross = att + dense_ffn + norms + 2 * d  # gate params
            return (emb + n_self * (att + dense_ffn + norms)
                    + n_cross * (att + dense_ffn + norms + cross) + d)
        else:
            per = att + dense_ffn + norms
        return emb + L * per + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts + fallback)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        eff = self.moe_d_ff or self.d_ff
        att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        active_moe = self.experts_per_token * 3 * d * eff + d * self.num_experts
        if self.parallel.moe_fallback:
            active_moe += 3 * d * eff
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (att + active_moe + 2 * d) + d

    def attn_layer_count(self) -> int:
        if self.family != "hybrid" or not self.block_pattern:
            return self.num_layers
        pat = self.block_pattern
        full, rem = divmod(self.num_layers, len(pat))
        return full * pat.count("attn") + sum(1 for b in pat[:rem] if b == "attn")

    def cross_attn_layer_count(self) -> int:
        if self.family != "vlm" or not self.cross_attn_every:
            return 0
        return self.num_layers // self.cross_attn_every

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Same family/wiring, tiny dims — used by per-arch smoke tests."""
        pat = self.block_pattern
        n_layers = max(len(pat), 2) if pat else 2
        if self.family == "vlm":
            n_layers = max(n_layers, self.cross_attn_every or 2)
        kv = min(self.num_kv_heads, 2) or 1
        heads = max(2 * kv, 2)
        hd = 8
        return self.replace(
            num_layers=n_layers,
            d_model=heads * hd,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=4 * heads * hd if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=8,
            ssm_chunk=8,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16,
            window=8 if self.window else 0,
            lru_width=0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            num_image_tokens=8 if self.family == "vlm" else self.num_image_tokens,
            dtype="float32",
            param_dtype="float32",
        )


def cell_status(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason): the reference's skip rule of an arch and a shape."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "skip: 500k-token decode requires sub-quadratic attention; "
            f"{cfg.name} is full-attention ({cfg.family})"
        )
    return True, "run"

"""Model configurations (the port's copy of ``repro.configs.base``).

Every assigned architecture is a :class:`ModelConfig`, and its
distribution knobs a :class:`ParallelConfig`, with the reference's
defaults.  The port reads ``capacity_factor`` and ``moe_fallback``
(``models/moe.py``).  The other fields are kept as the reference's config
data, because the configs set them, and nothing reads them yet:
``moe_dispatch`` waits for the shard_map dispatch (slice F), the rest for
the trainer (slice E).  The reference's sharding and remat knobs,
``InputShape``, ``SHAPES``, ``cell_status``, ``param_count`` and
``active_param_count`` come with the slices that read them (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["ModelConfig", "ParallelConfig", "VOCAB_PAD"]

VOCAB_PAD = 256  # vocab padded to a multiple of this


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution knobs, with the reference's defaults."""

    sequence_parallel: bool = False    # Megatron-SP activation sharding
    microbatches: int = 1              # grad-accum chunks (ENEAC iteration space)
    opt_state_dtype: str = "float32"   # "bfloat16" halves AdamW memory
    moe_dispatch: str = "gspmd"        # "gspmd" (global) | "local" (per-shard routing;
                                       # on one device the global path, as in the reference)
    grad_accum_dtype: str = "float32"  # bf16 halves the grad-accum resident
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
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

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

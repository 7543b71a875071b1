"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2*768 = 1536, head_dim 64 ⇒ 24 SSD heads; chunked SSD form with
chunk 256 for training/prefill, O(1) recurrent state for decode."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256 — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision family; unverified]

Backbone only: the vision tower is a STUB; ``input_specs()`` provides
precomputed patch embeddings (batch, 1024, d_model).  Cross-attention
blocks every 5th layer (20 of 100), gated, llama-3.2-vision style."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    num_image_tokens=1024,
)

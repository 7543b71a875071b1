"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2:1.
[arXiv:2402.19427]

Block pattern (rglru, rglru, attn) repeated; 38 layers = 12 full patterns
+ 2 trailing rglru blocks.  Local attention window 2048 ⇒ sub-quadratic:
runs the long_500k cell (KV cache is window-sized, RG-LRU state is O(1))."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,
    lru_width=4096,
    tie_embeddings=True,
)

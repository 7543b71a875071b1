"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

128 experts / 16-way model axis = 8 experts per shard ⇒ true expert
parallelism with all-to-all dispatch.  This is the cell most representative
of the paper's technique (irregular routing + capacity chunks + fallback)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,          # dense-equivalent ffn (used only by fallback sizing)
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
)

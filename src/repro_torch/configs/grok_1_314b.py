"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

8 experts < 16-way model axis ⇒ expert weights are tensor-parallel over
d_ff (2048/shard) with experts replicated along the expert dim — the
mesh_rules pick this automatically (see parallel/mesh_rules.py)."""

from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    # 314B on 256 chips: fp32 moments alone are 2.5 TB => bf16 moments;
    # 32 grad-accum microbatches bound the dispatch working set.
    parallel=ParallelConfig(
        opt_state_dtype="bfloat16", microbatches=16, moe_dispatch="local",
        grad_accum_dtype="bfloat16", sequence_parallel=True,
    ),
)

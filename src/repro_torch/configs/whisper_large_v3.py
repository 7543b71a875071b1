"""whisper-large-v3 [audio] — 32L d_model=1280 20H (kv=20, full MHA)
d_ff=5120 vocab=51866 — enc-dec, conv frontend STUB.  [arXiv:2212.04356]

Backbone only per the assignment: ``input_specs()`` supplies precomputed
frame embeddings of shape (batch, frames, d_model) standing in for the
conv1d+GELU frontend; 32 encoder + 32 decoder layers, learned positions,
no RoPE (flagged via rope_theta=0)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    rope_theta=0.0,           # learned absolute positions
)

"""Optimizer substrate: AdamW, schedules, clipping, gradient compression.

The port's copy of ``repro.optim``.
"""

from .adamw import AdamW, AdamWState, reference_decay_mask
from .clipping import clip_by_global_norm, global_norm
from .schedule import constant, warmup_cosine, warmup_linear_decay

__all__ = [
    "AdamW",
    "AdamWState",
    "reference_decay_mask",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
    "warmup_linear_decay",
    "constant",
]

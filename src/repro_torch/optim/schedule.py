"""LR schedules (pure functions of step), the port's copy of
``repro.optim.schedule``: each returns a float32 0-dim tensor."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant", "warmup_linear_decay"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)


def warmup_linear_decay(step, *, peak_lr: float, warmup_steps: int,
                        total_steps: int) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return torch.where(s < warmup_steps, warm, peak_lr * (1 - t))


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32)

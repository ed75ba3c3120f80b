"""Learning-rate schedules: f32 functions of the step counter.

Counterpart of ``repro/optim/schedules.py``. ``step`` is an int or a 0-d
integer tensor; the result is a 0-d f32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, lr: float):
    """``lr`` as an f32 tensor, whatever the step."""
    return torch.tensor(lr, dtype=torch.float32,
                        device=torch.as_tensor(step).device)

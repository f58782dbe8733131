"""LR schedules (pure functions of the step counter) — the port of the JAX
package's ``optim/schedule.py``.  ``step`` is a 0-d tensor (the train
state's counter) or a Python number; the result is a 0-d float32 tensor
on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, min_ratio: float = 0.1):
    step = _step(step)
    warm = peak_lr * torch.clamp_max((step + 1) / max(warmup_steps, 1), 1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, *, peak_lr: float, **_):
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=_step(step).device)

"""Learning-rate schedules: pure functions of the step counter (a Python
number or a tensor), returning an fp32 scalar tensor (on the step's
device), in ``repro.optim.schedule``'s fp32 arithmetic."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr).to(
        step.device if isinstance(step, torch.Tensor) else "cpu")


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(_f32(step / max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return sched


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def sched(step):
        warm = _f32(lr * step / max(warmup_steps, 1))
        return torch.where(_f32(step) < warmup_steps, warm,
                           cos(step - warmup_steps))
    return sched

"""LR schedules: functions of a step tensor returning a 0-d f32 tensor on
its device (no host sync), the values of ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr

"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
functions of the step (an int or a tensor) returning a float32 tensor."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        w = torch.clamp_max(step / max(warmup, 1), 1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr

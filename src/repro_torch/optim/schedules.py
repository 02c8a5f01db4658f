"""Learning-rate schedules (port of ``repro.optim.schedules``): pure
functions of the integer step, returning a float32 0-d tensor computed
in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def exponential_epoch_decay(lr: float, decay: float = 0.95,
                            steps_per_epoch: int = 1):
    """The paper's recipe: LR decreased by 5% after every epoch."""
    def fn(step):
        epoch = torch.as_tensor(step) // steps_per_epoch
        return torch.tensor(lr, dtype=_F32) * (decay ** epoch.to(_F32))
    return fn


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, total_steps, final_frac)

    def fn(step):
        s = _step(step)
        warm = lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        return torch.where(s < warmup_steps, warm, cos(step))
    return fn

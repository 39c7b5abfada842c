"""Learning-rate schedules. Port of `repro/optim/schedule.py`."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to `floor` of peak. Returns the
    scale as a 0-d f32 tensor, evaluated in f32 as the reference does; a
    tensor `step` keeps its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos

"""Learning-rate schedules: pure functions of the step.

The counterpart of ``repro/optim/schedule.py``. The step is a 0-dim device
tensor (``TrainState.step``) and so is the rate returned, on the step's
device, so that a train step reads its rate without a host sync
(``optim/adamw.py::update`` takes it as it is).
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  final_frac=0.1):
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine from ``peak_lr`` down to ``final_frac * peak_lr`` at
    ``total_steps``; f32, as the reference computes it."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * s / max(1.0, float(warmup_steps))
    t = ((s - warmup_steps) / max(1.0, total_steps - warmup_steps)).clamp(
        0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr, **_):
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)

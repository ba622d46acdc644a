"""Learning-rate schedules (``src/repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1):
    """Multiplicative LR scale in [min_ratio, 1]: linear warm-up over
    ``warmup`` steps, then a cosine down to ``min_ratio`` at ``total``.

    ``step`` is a Python number (the result is a float) or a tensor (the
    result is an f32 tensor on its device, computed as the reference
    computes it in f32).
    """
    if isinstance(step, torch.Tensor):
        step = step.float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return warm * cos
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))

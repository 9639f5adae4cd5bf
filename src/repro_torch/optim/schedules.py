"""LR schedules as ``step -> lr`` functions returning a float32 tensor on
the step's device (port of ``repro.optim.schedules``).

``wsd`` is the warmup-stable-decay schedule MiniCPM trains with
(arXiv:2404.06395): linear warmup, a long flat stage and a short
exponential decay tail.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine", "wsd"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_f32(step).device)


def cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio * lr + (1 - min_ratio) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        min_ratio: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM). Decay tail: exponential to
    ``min_ratio``."""
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = lr * (min_ratio ** t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, lr), dec))
    return f

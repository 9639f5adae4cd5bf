"""Optimizer: AdamW with float32 moments, LR schedules."""
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = ["AdamW", "OptState", "constant", "cosine", "wsd"]

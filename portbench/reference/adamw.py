"""Plain AdamW with global-norm clipping (Loshchilov and Hutter, 2019),
float32 moments, decoupled weight decay on every leaf with two or more
dims, a constant learning rate."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, lr, b1, b2, eps, weight_decay, clip_norm):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        self.t = 0
        self.m = self.v = None

    @torch.no_grad()
    def step(self, params: list, grads: list) -> float:
        """One update of the leaves in place; returns the gradient's
        global norm before clipping."""
        if self.m is None:
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9), max=1.0)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)
        return float(norm)

"""AdamW with float32 moments, global-norm clipping, and optional bf16
gradient compression with error feedback (port of ``repro.optim.adamw``).

Parameters and states are nested dicts of tensors with the parameters'
structure. ``update`` changes the parameters and the states IN PLACE under
``torch.no_grad()``, where the reference returns new arrays and donates the
old ones to the jitted step.

``compress_grads=True`` rounds ``grad + residual`` to bf16 and keeps the
float32 remainder as the next step's residual (``OptState.err``), so the
long-run update is unbiased while a data-parallel reduction would move
half the bytes. In sharded training every state is a local shard, and
the rounding works on the shard.

Weight decay applies to every parameter with ``ndim >= 2``, as in the
reference. That includes the layer-stacked ``(L, D)`` norm scales and the
``(L, H)`` ALiBi slopes, which the reference therefore decays too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.common import tree_zip_map as _zip_map

__all__ = ["AdamW", "OptState"]


@dataclasses.dataclass
class OptState:
    """``step`` (a 0-dim int32 tensor), the moments ``mu`` / ``nu`` and the
    error-feedback residuals ``err`` (None without compression). Saved in
    this field order, the reference's ``OptState`` leaf order."""
    step: torch.Tensor
    mu: dict
    nu: dict
    err: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False

    def init(self, params: dict) -> OptState:
        def zeros():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        device = tree_leaves(params)[0].device
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=device),
                        mu=zeros(), nu=zeros(),
                        err=zeros() if self.compress_grads else None)

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict, *,
               split_axes: Optional[dict] = None):
        """One step, in place. Returns (params, state, metrics) with
        metrics ``grad_norm`` (before clipping) and ``lr`` as 0-dim device
        tensors: nothing is read back to the host.

        ``split_axes`` (sharded training, under the ambient mesh): per
        leaf, the mesh axes its local shard is split on. The squares of
        the leaves split on the same axes are summed locally and then over
        those axes only, so a leaf replicated over an axis counts once,
        and the norm is the unsharded one. The moments and the residuals
        stay local shards, as the reference's out-shardings pin them."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.compress_grads:
            summed = _zip_map(torch.add, grads, state.err)
            grads = tree_map(lambda s: s.bfloat16().float(), summed)
            _zip_map(lambda e, s, c: torch.sub(s, c, out=e), state.err,
                     summed, grads)
            del summed
        if split_axes is None:
            gnorm = torch.sqrt(sum(g.square().sum()
                                   for g in tree_leaves(grads)))
        else:
            from repro_torch.dist.collectives import reduce_mesh_axes
            squares: dict = {}
            for g, axes in zip(tree_leaves(grads), tree_leaves(split_axes)):
                squares[axes] = squares.get(axes, 0) + g.square().sum()
            gnorm = torch.sqrt(sum(reduce_mesh_axes(v, axes)
                                   for axes, v in sorted(squares.items())))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = self.lr_fn(state.step)
        t = (state.step + 1).float()
        c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t

        def upd(p, g, m, n):
            # in place where the rounding is the reference's expression's:
            # a stacked leaf of GPT-2 1.5B's MLP is 3.9 GB in float32
            g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            n.mul_(self.b2).add_((1 - self.b2) * g * g)
            del g
            step = (m / c1).div_(torch.sqrt(n / c2).add_(self.eps))
            if p.ndim >= 2:          # decay matrices only (the reference's)
                step.add_(self.weight_decay * p.float())
            p.copy_((p.float() - lr * step).to(p.dtype))

        _zip_map(upd, params, grads, state.mu, state.nu)
        state.step += 1
        return params, state, {"grad_norm": gnorm, "lr": lr}

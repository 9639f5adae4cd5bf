"""Train-step factory (port of ``repro.train.step``): a loss function and
an optimizer make ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``.

- ``grad_accum > 1`` splits the batch's leading axis into ``(A, B/A,
  ...)`` microbatches, exactly as the reference reshapes it, runs one
  backward per microbatch (the gradients accumulate into each parameter's
  ``.grad`` in microbatch order) and averages the loss and the gradients
  over A.
- The optimizer updates the parameters in place, where the reference
  donates their buffers to its jitted step. The step runs eagerly: no
  compilation and no shardings (the reference's ``grad_shardings`` belongs
  to the distributed slice).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    grad_accum: int = 1) -> Callable:
    """``loss_fn(params, batch) -> scalar``. Returns ``step(params, opt,
    batch)``. Every parameter leaf is made to require grad; metrics are
    ``loss`` (the microbatch mean), ``grad_norm`` and ``lr``, 0-dim device
    tensors."""

    def microbatches(batch: dict):
        if grad_accum == 1:
            return [batch]
        split = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        return [{k: v[i] for k, v in split.items()}
                for i in range(grad_accum)]

    def step(params: dict, opt_state, batch: dict):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss_sum = None
        for mb in microbatches(batch):
            loss = loss_fn(params, mb)
            loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / grad_accum
        grads = tree_map(lambda p: (torch.zeros_like(p, dtype=torch.float32)
                                    if p.grad is None else p.grad.mul_(inv)),
                         params)
        for p in leaves:
            p.grad = None
        params, opt_state, metrics = optimizer.update(grads, opt_state,
                                                      params)
        return params, opt_state, dict(metrics, loss=loss_sum * inv)

    return step

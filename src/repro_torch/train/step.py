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
  compilation.
- ``mesh`` (a torch ``DeviceMesh``) with ``template`` and ``rules`` is the
  counterpart of the reference's step under ``use_mesh_rules`` with
  ``grad_shardings``: ``params`` and the optimizer state are this rank's
  local shards (``step.layout.shard``, a ``models.common.TrainLayout``),
  every rank is given the same GLOBAL batch, and each microbatch's rows
  are split over the ``batch`` ranks as evenly as possible
  (``even_range(B/A, "batch")``), so microbatch ``a`` covers the
  reference's global rows. Each rank's microbatch loss is weighted by its
  share of the microbatch's rows times the ranks holding different rows
  (1 at an even split); a rank that gets no row (``B/A`` below
  the ``batch`` ranks) runs its forward and backward on the microbatch's
  first row at weight 0, so every rank issues the same collectives, as
  the reference's GSPMD step pads such a batch. The loss runs under the
  ambient mesh, its ``fsdp`` gathers reduce-scatter each microbatch's
  gradient into the local shard (ZeRO-2: no full-size gradient exists),
  and after the last microbatch each gradient is summed over its
  remaining ``batch`` mesh axes (``TrainLayout.sum_axes``) and divided by
  those ranks and the microbatches: the global-batch mean the reference
  computes. It is exact for both terms of the loss: the cross-entropy
  is a mean over rows of equal length, and the MoE load-balance term a
  mean over rows of each row's own value. The loss metric is averaged the
  same way; ``grad_norm`` sums each shard's squares over the mesh axes it
  is split on.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.models.common import (TrainLayout, tree_leaves, tree_map,
                                       tree_zip_map)
from repro_torch.optim.adamw import AdamW

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    grad_accum: int = 1, mesh=None, rules=None,
                    template: Optional[dict] = None) -> Callable:
    """``loss_fn(params, batch) -> scalar``. Returns ``step(params, opt,
    batch)``. Every parameter leaf is made to require grad; metrics are
    ``loss`` (the microbatch mean), ``grad_norm`` and ``lr``, 0-dim device
    tensors. With ``mesh``, ``template`` (the model's parameter template)
    is required, ``rules`` defaults to ``dist.Rules()``, and
    ``step.layout`` is the ``TrainLayout`` the step expects its masters
    in (None without a mesh)."""
    from repro_torch.dist.collectives import (even_range, reduce_from,
                                              reduce_mesh_axes)
    from repro_torch.dist.sharding import Rules, use_mesh_rules
    layout = None
    if mesh is not None:
        if template is None:
            raise ValueError("a sharded train step needs the parameter "
                             "template")
        layout = TrainLayout(template, mesh, rules or Rules())

    def microbatches(batch: dict):
        """``[(microbatch, weight)]``: this rank's rows of each microbatch
        and the weight of its loss, its rows' share of the microbatch
        times the ``batch`` ranks (1 at an even split)."""
        if grad_accum == 1:
            mbs = [batch]
        else:
            split = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            mbs = [{k: v[i] for k, v in split.items()}
                   for i in range(grad_accum)]
        if layout is None:
            return [(mb, 1.0) for mb in mbs]
        n = next(iter(batch.values())).shape[0] // grad_accum
        rows = even_range(n, "batch")
        weight = (rows.stop - rows.start) * layout.n_batch / n
        if rows.stop == rows.start:          # a padding row, weight 0
            rows = slice(0, 1)
        return [({k: v[rows] for k, v in mb.items()}, weight)
                for mb in mbs]

    def step(params: dict, opt_state, batch: dict):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        ctx = (contextlib.nullcontext() if layout is None
               else use_mesh_rules(mesh, layout.rules))
        with ctx:
            loss_sum = None
            for mb, weight in microbatches(batch):
                loss = loss_fn(params, mb)
                if weight != 1.0:
                    loss = loss * weight
                loss.backward()
                loss = loss.detach().float()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            n = 1 if layout is None else layout.n_batch
            inv = 1.0 / (grad_accum * n)

            def grad(p, axes=()):
                if p.grad is None:
                    return torch.zeros_like(p, dtype=torch.float32)
                return reduce_mesh_axes(p.grad, axes).mul_(inv)
            loss_sum = reduce_from(loss_sum, "batch")
            for_leaf = {}
            if layout is None:
                grads = tree_map(grad, params)
            else:
                grads = tree_zip_map(grad, params, layout.sum_axes)
                for_leaf = {"split_axes": layout.split_axes}
            for p in leaves:
                p.grad = None
            params, opt_state, metrics = optimizer.update(
                grads, opt_state, params, **for_leaf)
        return params, opt_state, dict(metrics, loss=loss_sum * inv)

    step.layout = layout
    return step

"""Faults planted in the program under test, to show that the check of a
cell fails them (``run.py --fault NAME``, and the tests on the CPU). Each
patches one function of ``repro_torch`` for as long as the program runs
(set-up and window), never the reference.

- ``state_unchanged``: the optimizer's update returns the weights and its
  state as they were (a training step that does nothing);
- ``half_batch``: the loss sees half of each mesh's points and takes its
  mean over those;
- ``answer_altered``: the forward's answer for one point is moved by the
  answer's largest magnitude.

There is one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def _state_unchanged():
    from repro_torch.optim.adamw import AdamW

    def make(inner):
        def update(self, grads, state, params, **kw):
            zero = torch.zeros((), device=state.step.device)
            return params, state, {"grad_norm": zero,
                                   "lr": self.lr_fn(state.step)}
        return update
    return _patched(AdamW, "update", make)


def _half(batch: dict) -> dict:
    n = batch["coords"].shape[1] // 2
    return {k: v[:, :n] for k, v in batch.items()}


def _half_batch():
    from repro_torch.models import pde

    def make(inner):
        return lambda params, batch, cfg: inner(params, _half(batch), cfg)
    return _patched(pde, "regression_loss", make)


def _answer_altered():
    from repro_torch.models import pde

    def make(inner):
        def forward(params, coords, cfg):
            out = inner(params, coords, cfg).clone()
            out[:, 0] += out.abs().max()
            return out
        return forward
    return _patched(pde, "forward", make)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def plant(name):
    """A context in which the program carries fault ``name`` (None: none)."""
    return FAULTS[name]() if name else contextlib.nullcontext()

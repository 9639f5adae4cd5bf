"""Faults planted in the program under test, to show that the check of a
cell fails them (``run.py --fault NAME``, and the tests on the CPU). Each
patches one function of ``repro_torch`` for as long as the program runs
(set-up and window), never the reference.

A cell's faults come from its family's file (``families/<family>.py``, its
``FAULTS``: name -> a function returning the patch's context); its
driver's ``faults(ctx)`` names those its cells can have. The faults that
no family owns live here:

- ``state_unchanged``: the optimizer's update returns the weights and its
  state as they were (a training step that does nothing).

There is one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name, make):
    """``module.name`` replaced by ``make(inner)`` inside the block."""
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def state_unchanged():
    from repro_torch.optim.adamw import AdamW

    def make(inner):
        def update(self, grads, state, params, **kw):
            zero = torch.zeros((), device=state.step.device)
            return params, state, {"grad_norm": zero,
                                   "lr": self.lr_fn(state.step)}
        return update
    return patched(AdamW, "update", make)


def plant(family, name):
    """A context in which the program carries fault ``name`` of the family
    module ``family`` (None: none)."""
    if not name:
        return contextlib.nullcontext()
    if name not in family.FAULTS:
        raise KeyError(f"no fault {name!r} in {family.__name__} "
                       f"(it has {sorted(family.FAULTS)})")
    return family.FAULTS[name]()

"""Named spans on the profiler's timeline at the program's layer boundaries.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is recording, and does nothing otherwise: untraced, a span costs
one check of the profiler's state. A range lands on kineto's clock, the
clock of the CUDA activity, so a trace holds the program's spans, its
caller's and the device's operations on one timeline.

The spans, named ``repro_torch.<layer>.<what>``:

- ``repro_torch.attn.fwd``: the whole of ``kernels/ops.py``
  ``flash_attention`` (the autograd path and the ragged one), on the
  caller's thread. No metric reads it yet.
- ``repro_torch.attn.bwd``: the whole of ``ops._FlashAttention.backward``
  (recompute, gradients, the cast back), on the autograd engine's thread
  (its device thread on the card). Read by ``attn_bwd_share.train`` and
  ``attn_bwd_roofline.train`` (``portbench/metrics/``).
- ``repro_torch.pde.forward``: the body of ``models/pde.py`` ``forward``,
  on the caller's thread. Read by ``forward_idle_share.infer``.

Each sits at a boundary, not inside one implementation: whatever computes
the attention's forward or backward runs inside the same span.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is
    recording, else a no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()

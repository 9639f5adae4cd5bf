"""The collectives a sharded serve or train step runs on local shards.

GSPMD derives a sharded program's collectives from its sharding
constraints; the port runs each layer body on plain local shards
(``DTensor.to_local()``) and writes the few collectives by hand, as
functional collectives over the mesh axes a logical axis resolves to under
the ambient ``use_mesh_rules`` pair. Outside such a context, or where the
logical axis resolves to one rank, each helper is the identity and starts
no collective: the unsharded path, and a one-card mesh, pay nothing.

- ``local_part(x, dim, "heads")``: this rank's shard of a replicated
  tensor (the ALiBi slopes of the local heads; the page-table rows of the
  local slots).

Both paths sum and gather through the helpers below, and the training
path needs the backward of each collective too. The functional
collectives' own autograd does not give it: the backward of
``funcol.all_reduce`` sums the cotangents over the ranks (a gradient
comes out multiplied by their number), that of an autograd all-gather is
a summing reduce-scatter. Ranks along a
tensor-parallel axis compute the SAME loss on replicated activations, so
a gradient that enters a reduction is already the whole gradient on every
rank. The training helpers are therefore Megatron's operator pair and two
gathers, each a ``torch.autograd.Function``:

- ``reduce_from(x, logical)`` (Megatron's *g*): all-reduce forward,
  identity backward. Where partial products leave a tensor-parallel
  region: after ``wo``, the FFN's ``wo``, the MoE combine, the embedding
  lookup over ``vocab``; the serve path's sums too.
- ``copy_to(x, logical)`` (Megatron's *f*): identity forward, all-reduce
  backward. Where a replicated activation enters a tensor-parallel region
  (the attention and FFN inputs, the MoE dispatch and its gates, the final
  hidden state before the ``vocab``-split unembedding, the replicated
  slopes before ``local_part``): each rank's backward holds the part of the
  gradient its own heads, columns, experts or vocab rows give, and the sum
  is the whole.
- ``gather_from(x, dim, logical)``: all-gather forward, the local slice
  backward (the logits over ``vocab``: every rank's loss, hence its
  cotangent, is the whole one already; the serve path's slot rows over
  ``batch``).
- ``fsdp_gather(x, dim, dtype)``: the float32 shard cast to ``dtype`` and
  all-gathered over ``fsdp`` forward, a summing reduce-scatter backward.
  The ``fsdp`` ranks hold different batch rows, so their gradients of a
  gathered weight are different parts of one sum, and each keeps the sum
  over its own shard (ZeRO-3's gather; ZeRO-2's reduce-scatter of the
  gradient). The sum runs in the shard's float32, as FSDP's
  ``reduce_dtype``: each rank's bf16 part is rounded once, as a
  microbatch's is, and the sum over the ranks adds no rounding however
  many there are (a bf16 reduce-scatter would add one per rank).
  Its backward moves float32: twice the bytes of a bf16 reduce-scatter.

``reduce_mesh_axes(x, axes)`` sums a tensor over explicit mesh axes (the
train step's gradient sums over the ``batch`` axes). Every helper is the
identity outside a mesh and over one rank, and starts no collective.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.dist.sharding import get_active_mesh, spec_for

__all__ = ["axis_size", "axis_rank", "even_range", "local_part",
           "local_range", "reduce_from", "copy_to",
           "gather_from", "fsdp_gather", "reduce_mesh_axes"]

_GROUPS: dict = {}     # (id(mesh), id(rules), logical) -> (group, size, rank)
_MESH_GROUPS: dict = {}   # (id(mesh), mesh axes) -> (mesh, (group, size, rank))


def _mesh_group(mesh, entry) -> Optional[tuple]:
    """(group, size, rank) of the ranks that differ only along the mesh
    axes ``entry`` (a tuple of names, major to minor), or None where they
    are one rank. Cached: flattening several axes builds a process group,
    which every rank must do in the same order."""
    key = (id(mesh), tuple(entry or ()))
    if key not in _MESH_GROUPS:
        found = None
        if entry:
            dims = [mesh.mesh_dim_names.index(a) for a in entry]
            size = math.prod(mesh.size(d) for d in dims)
            if size > 1:
                rank = 0
                for d in dims:                       # major to minor
                    rank = rank * mesh.size(d) + mesh.get_local_rank(d)
                # a flattened mesh holds real tensors, under a fake mode too
                with unset_fake_temporarily():
                    group = ((mesh, dims[0]) if len(dims) == 1
                             else mesh[tuple(entry)]._flatten())
                found = (group, size, rank)
        _MESH_GROUPS[key] = (mesh, found)             # keep the id alive
    return _MESH_GROUPS[key][1]


def _axis(logical: str) -> Optional[tuple]:
    """(group, size, rank) of the ranks ``logical`` shards over under the
    ambient mesh, or None where it is not sharded (or on one rank)."""
    ctx = get_active_mesh()
    if ctx is None:
        return None
    mesh, rules = ctx
    key = (id(mesh), id(rules), logical)
    if key not in _GROUPS:
        entry = spec_for((logical,), mesh, rules)[0]
        _GROUPS[key] = (mesh, rules, _mesh_group(mesh, entry))
    return _GROUPS[key][2]


def axis_size(logical: str) -> int:
    """Ranks ``logical`` shards over (1 outside a mesh)."""
    ax = _axis(logical)
    return 1 if ax is None else ax[1]


def axis_rank(logical: str) -> int:
    """This rank's index along ``logical`` (0 outside a mesh)."""
    ax = _axis(logical)
    return 0 if ax is None else ax[2]


def _waited(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def local_range(n: int, logical: str) -> slice:
    """The slice of a length-``n`` dim this rank holds along ``logical``."""
    ax = _axis(logical)
    if ax is None:
        return slice(0, n)
    size, rank = ax[1], ax[2]
    if n % size:
        raise ValueError(f"a dim of {n} does not split over {size} ranks "
                         f"of '{logical}'")
    step = n // size
    return slice(rank * step, (rank + 1) * step)


def even_range(n: int, logical: str) -> slice:
    """This rank's rows of a length-``n`` dim split over ``logical`` as
    evenly as possible: the first ``n % size`` ranks take one row more, and
    a rank past ``n`` gets an empty slice (where ``local_range`` would
    raise)."""
    ax = _axis(logical)
    if ax is None:
        return slice(0, n)
    size, rank = ax[1], ax[2]
    step, extra = divmod(n, size)
    lo = rank * step + min(rank, extra)
    return slice(lo, lo + step + (rank < extra))


def local_part(x: torch.Tensor, dim: int, logical: str) -> torch.Tensor:
    """This rank's shard of a tensor replicated along ``logical`` (a view)."""
    ax = _axis(logical)
    if ax is None:
        return x
    sl = local_range(x.shape[dim], logical)
    return x.narrow(dim, sl.start, sl.stop - sl.start)


# ---------------------------------------------------------------------------
# Sums and gathers, with the backward a replicated loss needs
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_reduce(x.contiguous(), "sum", group))


def _funcol(name: str, older: str):
    """A functional collective by its name, or by its older name (on a
    release that lacks the newer one; later releases deprecate the
    older)."""
    from torch.distributed import _functional_collectives as funcol
    return getattr(funcol, name, None) or getattr(funcol, older)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    gather = _funcol("all_gather_single", "all_gather_tensor")
    return _waited(gather(x.contiguous(), dim, group))


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward; identity backward (the cotangent of the reduced,
    replicated output is each partial product's whole cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; all-reduce backward (the ranks' parts of the
    gradient of a replicated input sum to the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None,
                None)


class _FsdpGather(torch.autograd.Function):
    """Cast to ``dtype`` and all-gather along ``dim`` forward; the
    gradient cast back to the input's dtype and reduce-scattered (summed)
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, x.dtype
        return _all_gather(x.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, grad):
        scatter = _funcol("reduce_scatter_single", "reduce_scatter_tensor")
        return (_waited(scatter(grad.to(ctx.dtype).contiguous(), "sum",
                                ctx.dim, ctx.group)), None, None, None)


def reduce_from(x: torch.Tensor, logical: str) -> torch.Tensor:
    """Sum ``x`` over the ranks ``logical`` shards over (Megatron's *g*:
    all-reduce forward, identity backward)."""
    ax = _axis(logical)
    return x if ax is None else _ReduceFrom.apply(x, ax[0])


def copy_to(x: torch.Tensor, logical: str) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the ranks ``logical``
    shards over (Megatron's *f*: identity forward, all-reduce backward)."""
    ax = _axis(logical)
    return x if ax is None else _CopyTo.apply(x, ax[0])


def gather_from(x: torch.Tensor, dim: int, logical: str) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated along ``dim`` (all-gather
    forward; the backward keeps this rank's slice of the cotangent)."""
    ax = _axis(logical)
    if ax is None:
        return x
    return _GatherFrom.apply(x, dim % x.dim(), ax[0], ax[2])


def fsdp_gather(x: torch.Tensor, dim: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A weight's ``fsdp`` shards, cast to ``dtype`` (default: as they
    are), concatenated along ``dim`` (all-gather forward; the backward
    reduce-scatters the gradient in ``x``'s dtype, summed over the ranks,
    so each keeps the sum over its own shard). Outside a mesh or on one
    rank, ``x`` cast."""
    dtype = x.dtype if dtype is None else dtype
    ax = _axis("fsdp")
    if ax is None:
        return x.to(dtype)
    return _FsdpGather.apply(x, dim % x.dim(), ax[0], dtype)


def reduce_mesh_axes(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum ``x`` over the ranks that differ along the mesh axes ``axes``
    of the ambient mesh (no autograd; identity over one rank)."""
    ctx = get_active_mesh()
    ax = None if ctx is None else _mesh_group(ctx[0], tuple(axes))
    return x if ax is None else _all_reduce(x, ax[0])

"""The collectives a sharded serve step runs on local shards.

GSPMD derives a sharded program's collectives from its sharding
constraints; the port runs each layer body on plain local shards
(``DTensor.to_local()``) and writes the few collectives by hand, as
functional collectives over the mesh axes a logical axis resolves to under
the ambient ``use_mesh_rules`` pair. Outside such a context, or where the
logical axis resolves to one rank, each helper is the identity and starts
no collective: the unsharded path, and a one-card mesh, pay nothing.

- ``reduce_over(x, "heads")``: sum the partial products of the local heads
  (after the attention's ``wo``; ``"mlp"`` after the FFN's, ``"expert"``
  after the MoE combine, ``"vocab"`` after the embedding lookup).
- ``gather_over(x, dim, "vocab")``: concatenate the local shards along
  ``dim`` (the logits over ``vocab``; slot rows over ``batch``).
- ``local_part(x, dim, "heads")``: this rank's shard of a replicated
  tensor (the ALiBi slopes of the local heads; the page-table rows of the
  local slots).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.sharding import get_active_mesh, spec_for

__all__ = ["axis_size", "axis_rank", "reduce_over", "gather_over",
           "local_part", "local_range"]

_GROUPS: dict = {}     # (id(mesh), id(rules), logical) -> (group, size, rank)


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
        found = None
        if entry:
            dims = [mesh.mesh_dim_names.index(a) for a in entry]
            size = math.prod(mesh.size(d) for d in dims)
            if size > 1:
                rank = 0
                for d in dims:                       # major to minor
                    rank = rank * mesh.size(d) + mesh.get_local_rank(d)
                group = ((mesh, dims[0]) if len(dims) == 1
                         else mesh[tuple(entry)]._flatten())
                found = (group, size, rank)
        _GROUPS[key] = (mesh, rules, found)          # keep the ids alive
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


def reduce_over(x: torch.Tensor, logical: str) -> torch.Tensor:
    """Sum ``x`` over the ranks ``logical`` shards over (all-reduce)."""
    ax = _axis(logical)
    if ax is None:
        return x
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_reduce(x.contiguous(), "sum", ax[0]))


def gather_over(x: torch.Tensor, dim: int, logical: str) -> torch.Tensor:
    """Concatenate the ranks' shards of ``x`` along ``dim`` (all-gather)."""
    ax = _axis(logical)
    if ax is None:
        return x
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor          # the older name
    return _waited(gather(x.contiguous(), dim % x.dim(), ax[0]))


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


def local_part(x: torch.Tensor, dim: int, logical: str) -> torch.Tensor:
    """This rank's shard of a tensor replicated along ``logical`` (a view)."""
    ax = _axis(logical)
    if ax is None:
        return x
    sl = local_range(x.shape[dim], logical)
    return x.narrow(dim, sl.start, sl.stop - sl.start)

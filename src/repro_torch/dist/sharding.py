"""Logical-axis sharding on a torch ``DeviceMesh``: one rule set drives
every mesh shape (port of ``repro.dist.sharding``).

Parameters, caches and activations name their dims with *logical* axes
(``fsdp``, ``heads``, ``batch``, ...); ``Rules`` maps each logical axis to
the mesh axes it shards over. ``spec_for`` resolves a tuple of logical axes
against a concrete mesh to one entry per tensor dim: ``None`` (replicated)
or a tuple of mesh-axis names — always a tuple, never a bare string. Mesh
axes the mesh lacks drop, and so does one already used earlier in the same
spec, so the same rules drive a 2D ``(data, model)`` mesh and a 3D ``(pod,
data, model)`` one. ``placements_for`` turns a spec into DTensor
placements, one per mesh dim.

Default vocabulary (the reference's):

==========  =====================  =========================================
logical     default mesh axes      sharded dim of
==========  =====================  =========================================
batch       ("pod", "data")        activation / slot batch (DP)
seq         replicated             activation sequence (SP/CP via overrides)
fsdp        ("data",)              weight d_model dim (ZeRO-3 gather axis)
heads       ("model",)             q-head dim (TP)
kv_heads    ("model",)             kv-head dim (TP)
mlp         ("model",)             FFN hidden dim (TP)
vocab       ("model",)             embedding / logits vocab dim (TP)
expert      ("model",)             MoE expert dim (EP)
kv_seq      replicated             decode KV-cache sequence dim
layers      replicated             stacked-layers dim
==========  =====================  =========================================

``use_mesh_rules(mesh, rules)`` makes a (mesh, rules) pair ambient.
GSPMD inserts the collectives a sharded JAX program needs; the port runs
each layer on plain local shards and writes them itself, through
``repro_torch.dist.collectives``, which reads the ambient pair. Outside any
such context every helper there, and ``constrain``, is the identity, so
model code calls them unconditionally and the unsharded path pays nothing.

A mesh is duck-typed wherever only its axis names and sizes are read: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``) or any object with
``axis_names`` and a ``shape`` mapping (the reference's ``jax`` mesh).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["Rules", "spec_for", "batch_axes_for", "use_mesh_rules",
           "get_active_mesh", "constrain", "shard_put", "DEFAULT_RULES",
           "mesh_axis_sizes", "placements_for", "degraded_spec",
           "even_rules", "split_axes", "grad_sum_axes"]

# One logical axis maps to: None (replicate) or a tuple of mesh axis names.
MeshAxes = Optional[Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "kv_seq": None,
    "layers": None,
}


def _norm(v) -> MeshAxes:
    if v is None:
        return None
    if isinstance(v, str):
        return (v,)
    return tuple(v)


class Rules:
    """Immutable logical-axis -> mesh-axes table.

    ``Rules()`` is the default (FSDP x TP with the pod axis folded into
    DP). ``Rules.make({...})`` overlays overrides — a mesh-axis name, a
    tuple of names, or ``None`` (replicate); logical axes absent from the
    table resolve to replicated, so overrides can introduce new vocabulary.
    """

    __slots__ = ("_table",)

    def __init__(self, table: Optional[Mapping[str, MeshAxes]] = None):
        merged = dict(DEFAULT_RULES)
        if table:
            merged.update({k: _norm(v) for k, v in table.items()})
        object.__setattr__(self, "_table", merged)

    @classmethod
    def make(cls, overrides: Optional[Mapping] = None) -> "Rules":
        return cls(overrides)

    def __setattr__(self, name, value):
        raise AttributeError("Rules is immutable; use Rules.make({...})")

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return _norm(self._table.get(logical))

    @property
    def table(self) -> Mapping[str, MeshAxes]:
        return dict(self._table)

    def __repr__(self):
        return f"Rules({self._table!r})"

    def __eq__(self, other):
        return isinstance(other, Rules) and self._table == other._table

    def __hash__(self):
        return hash(tuple(sorted(self._table.items())))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: size}, in the mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def spec_for(axes: Sequence[Optional[str]], mesh, rules: Rules) -> Spec:
    """Resolve logical ``axes`` to one entry per dim: ``None`` or a tuple
    of mesh-axis names.

    Mesh axes the mesh lacks are dropped (``pod`` on a single-pod mesh); a
    mesh axis already consumed earlier in the same spec is dropped too
    (first occurrence wins), so overrides like sequence parallelism (``seq
    -> model``) never produce a double use. An entry whose mesh axes all
    drop becomes ``None`` (replicated)."""
    present = set(mesh_axis_sizes(mesh))
    used: set = set()
    entries = []
    for logical in axes:
        ax = rules.mesh_axes(logical)
        if ax is None:
            entries.append(None)
            continue
        kept = tuple(a for a in ax if a in present and a not in used)
        used.update(kept)
        entries.append(kept if kept else None)
    return tuple(entries)


def _product(entry: MeshAxes, sizes: Dict[str, int]) -> int:
    return math.prod(sizes[a] for a in entry) if entry else 1


def batch_axes_for(batch: int, mesh, rules: Rules) -> Spec:
    """Spec of a length-``batch`` leading dim: ``(dp_axes,)`` when ``batch``
    divides the DP product, else ``(None,)`` (replicated — never an error,
    so any slot count places)."""
    spec = degraded_spec((batch,), ("batch",), mesh, rules)
    if _product(spec[0], mesh_axis_sizes(mesh)) <= 1:
        return (None,)
    return spec


def degraded_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Rules) -> Spec:
    """``spec_for(axes)`` with every sharded dim that does not divide its
    mesh-axis product replicated instead (a ``"batch"`` dim included): the
    rule ``shard_put`` places by."""
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} axes for rank-{len(shape)} shape "
                         f"{tuple(shape)}")
    sizes = mesh_axis_sizes(mesh)
    entries = list(spec_for(axes, mesh, rules))
    for i, entry in enumerate(entries):
        n = _product(entry, sizes)
        if n > 1 and int(shape[i]) % n:
            entries[i] = None
    return tuple(entries)


def even_rules(leaves, mesh, rules: Rules,
               batch: Optional[int] = None) -> Rules:
    """``rules`` with every logical axis that some leaf (``(shape, axes)``
    pairs) cannot split evenly over its mesh axes replicated for ALL
    leaves, ``batch`` too where a given row count does not split, and
    ``heads`` / ``kv_heads`` replicated together (a layer's local q heads
    must group over its local kv heads). The model's collectives read one
    logical axis for every leaf, so placement and collectives then agree
    leaf for leaf, where ``shard_put`` alone replicates leaf by leaf."""
    sizes = mesh_axis_sizes(mesh)

    def split(logical):
        return _product(spec_for((logical,), mesh, rules)[0], sizes)

    drop = {a for shape, axes in leaves for n, a in zip(shape, axes)
            if a is not None and n % split(a)}
    if batch is not None and batch % split("batch"):
        drop.add("batch")
    if drop & {"heads", "kv_heads"}:
        drop |= {"heads", "kv_heads"}
    return Rules.make({**rules.table, **{a: None for a in drop}})


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a leaf of ``spec`` is split on, over all its dims."""
    return tuple(a for entry in spec for a in (entry or ()))


def grad_sum_axes(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes over which a training step must still sum a leaf's
    gradient after its backward: the ``batch`` mesh axes (their ranks hold
    different rows of the global batch), minus those its ``fsdp`` gather
    already reduce-scattered over. On a ``(pod, data, model)`` mesh an
    ``fsdp`` leaf sums over ``pod`` (the reduce-scatter covered ``data``:
    the intra-pod reduce-scatter and inter-pod all-reduce), a replicated
    leaf over ``pod`` and ``data``; a dim ``degraded_spec`` replicates
    counts as replicated. ``model`` never appears: its ranks compute the
    same loss, and ``collectives.copy_to`` already summed their parts."""
    spec = degraded_spec(shape, axes, mesh, rules)
    gathered = {a for logical, entry in zip(axes, spec)
                if logical == "fsdp" for a in (entry or ())}
    batch = spec_for(("batch",), mesh, rules)[0] or ()
    return tuple(a for a in batch if a not in gathered)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    for the tensor dim ``d`` whose entry names it, else ``Replicate()``. A
    dim sharded over several mesh axes (``("pod", "data")``) is split
    major-to-minor in the mesh's dim order, as a ``PartitionSpec`` tuple
    entry is."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {a: d for d, entry in enumerate(spec) for a in (entry or ())}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_put(x: torch.Tensor, mesh, rules: Rules,
              axes: Sequence[Optional[str]]):
    """``x`` as a ``DTensor`` on ``mesh`` with the placement its logical
    ``axes`` resolve to (one per dim). A sharded dim that does not divide
    its mesh-axis product — a ``"batch"`` dim of an odd slot count, or any
    other — is replicated instead, with no error: serve state must always
    place. Every rank holds the same full ``x`` (made from one seed), so
    each takes its own shard without a collective."""
    from torch.distributed.tensor import distribute_tensor
    spec = degraded_spec(tuple(x.shape), axes, mesh, rules)
    return distribute_tensor(x, mesh, placements_for(spec, mesh),
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Ambient (mesh, rules) context
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


def get_active_mesh() -> Optional[Tuple[object, Rules]]:
    """Innermost ``use_mesh_rules`` (mesh, rules) pair, or ``None``."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Rules):
    """Make (mesh, rules) ambient for ``constrain``, ``get_active_mesh``
    and the collectives of ``repro_torch.dist.collectives``. Nests: the
    innermost pair wins and the outer one is restored on exit."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append((mesh, rules))
    try:
        yield mesh
    finally:
        stack.pop()


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Pin a ``DTensor`` to the placement its logical axes resolve to
    (``redistribute``). Identity when no mesh is active, and for a plain
    tensor, which is a local shard whose layout its caller fixed. Rank must
    match: one logical axis (or ``None``) per dim."""
    ctx = get_active_mesh()
    if ctx is None:
        return x
    if len(logical_axes) != x.dim():     # not assert: must survive python -O
        raise ValueError(
            f"constrain: {len(logical_axes)} logical axes {logical_axes} "
            f"for rank-{x.dim()} tensor of shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = degraded_spec(tuple(x.shape), logical_axes, mesh, rules)
    return x.redistribute(mesh, placements_for(spec, mesh))

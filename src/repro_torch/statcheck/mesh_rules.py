"""Mesh checks of a sharded serve backend (port of
``repro.statcheck.mesh_rules``).

The reference compiles a program under its mesh and looks for collectives
in the HLO. The port runs one step under
``torch.distributed.tensor.debug.CommDebugMode`` and counts the
collectives it issued — the difference between "the mesh split the work"
and "every rank quietly computed everything":

- ``check_collectives``: the counted collectives include at least one of
  ``expect_any``, every one of ``expect_all`` and none of ``forbid``.
- ``check_state_axes``: every logical axis a backend names its state with
  (``_state_axes()``) is in the ``Rules`` vocabulary; an unknown name
  would silently resolve to replicated.
- ``check_shard_divisibility``: ``shard_put`` replicates a dim that does
  not divide its mesh axes BY DESIGN (state must always place); this
  reports each (leaf, dim) that would, outside an allow-list, so the
  replication is a decision, never a surprise.
- ``check_backend_mesh``: the three on a live backend.
- ``check_train_step``: one step of a sharded train step counted, the
  counterpart of the reference's ``test_mini_multipod_lowering`` "has real
  collectives": all-gathers and reduce-scatters of the FSDP weights where
  ``fsdp`` splits, all-reduces where a tensor-parallel axis splits, and the
  FSDP gathers per step held to ``fsdp_gathers_per_step`` — a gather
  hoisted out of the layer body, or a backward that does not gather again
  under remat, shows as a count off the formula.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.dist.sharding import Rules, mesh_axis_sizes, spec_for
from repro_torch.statcheck.oplog_rules import Finding

__all__ = ["COLLECTIVE_OPS", "Finding", "count_collectives",
           "check_collectives", "check_state_axes", "shard_degradations",
           "check_shard_divisibility", "check_backend_mesh",
           "fsdp_gathers_per_step", "check_train_step"]

# the functional collectives a TP/DP-sharded step can issue
COLLECTIVE_OPS = ("all_reduce", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single", "broadcast")


def count_collectives(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), {collective: count})``, the count of every
    collective op the call issued (``CommDebugMode``), by its op name."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        out = fn(*args, **kwargs)
    counts: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        counts[name] = counts.get(name, 0) + int(n)
    return out, counts


def check_collectives(counts: Dict[str, int], *, program: str,
                      expect_any: Sequence[str] = COLLECTIVE_OPS,
                      expect_all: Sequence[str] = (),
                      forbid: Sequence[str] = ()) -> List[Finding]:
    """Collective presence / absence in one step's ``counts``:
    ``expect_any`` guards against a cosmetic mesh, ``expect_all`` pins ops
    a program needs (the heads' all-reduce), ``forbid`` bans ops it must
    never issue."""
    found = sorted(op for op, n in counts.items() if n)
    findings = []
    if expect_any and not any(op in found for op in expect_any):
        findings.append(Finding(
            "mesh-collectives", program,
            f"the step issued none of {tuple(expect_any)} — the mesh "
            f"sharding is cosmetic (every rank computed everything)"))
    for op in expect_all:
        if op not in found:
            findings.append(Finding(
                "mesh-collectives", program,
                f"expected collective '{op}' missing (found: "
                f"{found or 'none'})"))
    for op in forbid:
        if op in found:
            findings.append(Finding(
                "mesh-collectives", program,
                f"forbidden collective '{op}' issued {counts[op]} times"))
    return findings


def check_state_axes(axes_map: Dict[str, Tuple[Optional[str], ...]],
                     rules: Rules, *, program: str,
                     extra_vocab: Iterable[str] = ()) -> List[Finding]:
    """Every logical axis named in ``axes_map`` (leaf -> per-dim axes) is in
    the ``Rules`` vocabulary (or ``extra_vocab``)."""
    vocab = set(rules.table) | set(extra_vocab)
    findings = []
    for leaf, axes in axes_map.items():
        for d, logical in enumerate(axes):
            if logical is not None and logical not in vocab:
                findings.append(Finding(
                    "state-axes-vocab", program,
                    f"cache leaf '{leaf}' dim {d} names unknown logical "
                    f"axis '{logical}' (vocabulary: {sorted(vocab)}) — it "
                    f"would silently replicate"))
    return findings


def shard_degradations(shapes: Dict[str, Tuple[int, ...]],
                       axes_map: Dict[str, Tuple[Optional[str], ...]],
                       mesh, rules: Rules) -> List[Tuple[str, int, str]]:
    """(leaf, dim, logical axis) where ``shard_put`` would replicate a dim
    of the global ``shapes`` on ``mesh`` (its size does not divide its
    mesh-axis product)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for leaf, shape in shapes.items():
        axes = axes_map.get(leaf)
        if axes is None:
            continue
        for d, (logical, entry) in enumerate(
                zip(axes, spec_for(axes, mesh, rules))):
            n = math.prod(sizes[a] for a in entry) if entry else 1
            if n > 1 and int(shape[d]) % n:
                out.append((leaf, d, str(logical)))
    return out


def check_shard_divisibility(shapes: Dict[str, Tuple[int, ...]],
                             axes_map: Dict[str, Tuple[Optional[str], ...]],
                             mesh, rules: Rules, *, program: str,
                             allow: Iterable[str] = ("length",),
                             ) -> List[Finding]:
    """A finding for each leaf outside ``allow`` that would lose its
    sharding: slot rows may replicate (any ``n_slots`` is served), but a KV
    pool that replicates multiplies its memory by the mesh-axis size."""
    allowed = set(allow)
    return [Finding("shard-divisibility", program,
                    f"cache leaf '{leaf}' dim {dim} (logical '{logical}') "
                    f"does not divide its mesh axes on "
                    f"{mesh_axis_sizes(mesh)} — shard_put would replicate it")
            for leaf, dim, logical in shard_degradations(shapes, axes_map,
                                                         mesh, rules)
            if leaf not in allowed]


def check_backend_mesh(backend, *, program: str = "decode",
                       expect_any: Sequence[str] = COLLECTIVE_OPS,
                       expect_all: Sequence[str] = (),
                       forbid: Sequence[str] = ()) -> List[Finding]:
    """The three rules on a live sharded token backend: its state axes in
    the vocabulary, no pool-sized leaf replicated by the divisibility rule,
    and collectives counted in one decode step (the model's, then the
    gather of every slot's logits), run on a copy of its state (the step
    writes the cache in place)."""
    import torch
    if backend.mesh is None:
        raise ValueError("backend has no mesh")
    backend.ensure_state()
    axes_map = {k: v for k, v in backend._state_axes().items()
                if k in backend._cache}
    findings = check_state_axes(axes_map, backend.rules, program=program)
    shapes = {k: tuple(d.shape) for k, d in backend.state_dtensors().items()
              if k in axes_map}
    findings += check_shard_divisibility(
        shapes, axes_map, backend.mesh, backend.rules, program=program,
        allow=("length", "ssm_h", "conv_x", "conv_bc"))
    from repro_torch.dist.collectives import gather_from
    cache = {k: v.clone() for k, v in backend._cache.items()}

    def step():                  # the backend's step: decode, gather rows
        logits, _ = backend.model.decode(backend.params, cache,
                                         backend._last_tok,
                                         max_pages=backend.page_cap({}))
        return gather_from(logits[:, 0], 0, "batch")

    with torch.no_grad(), backend._sharded():
        _, counts = count_collectives(step)
    findings += check_collectives(counts, program=program,
                                  expect_any=expect_any,
                                  expect_all=expect_all, forbid=forbid)
    return findings


def _fsdp_split_leaves(layout) -> Tuple[int, int]:
    """(per-layer leaves, other leaves) whose ``fsdp`` dim ``layout`` splits
    over more than one rank (a dim that does not divide is replicated)."""
    from repro_torch.models.common import template_map, tree_leaves
    sizes = mesh_axis_sizes(layout.mesh)

    def split(p, spec, path):
        if "fsdp" not in p.axes:
            return 0
        entry = spec[p.axes.index("fsdp")]
        n = math.prod(sizes[a] for a in entry) if entry else 1
        return (2 if path[0] == "layers" else 1) if n > 1 else 0
    flags = tree_leaves(template_map(split, layout.template, layout.specs))
    return flags.count(2), flags.count(1)


def fsdp_gathers_per_step(layout, cfg) -> Tuple[int, int]:
    """(all-gathers, reduce-scatters) of the FSDP weights in one step:
    each layer leaf whose ``fsdp`` dim splits is gathered once per layer
    and microbatch, and once more where remat recomputes the layer in the
    backward; each other such leaf (the tied embedding) once per
    microbatch. Each gather's backward reduce-scatters once."""
    per_layer, other = _fsdp_split_leaves(layout)
    remat = 1 if cfg.remat == "none" else 2
    a = cfg.grad_accum
    return (a * (per_layer * cfg.n_layers * remat + other),
            a * (per_layer * cfg.n_layers + other))


def check_train_step(step, params, opt_state, batch, cfg, *,
                     program: str = "train"):
    """Run ``step`` (a ``make_train_step(mesh=)`` step) once under
    ``CommDebugMode`` on ``params`` / ``opt_state`` (updated in place) and
    check its collectives: where ``fsdp`` splits, the all-gathers and
    reduce-scatters of the FSDP weights, their counts equal to
    ``fsdp_gathers_per_step`` (the all-gathers plus one logits gather per
    microbatch where ``vocab`` splits); where a tensor-parallel axis
    splits, an all-reduce. Returns (counts, findings)."""
    from repro_torch.models.common import TP_AXES
    layout = step.layout
    if layout is None:
        raise ValueError("the step has no mesh")
    sizes = mesh_axis_sizes(layout.mesh)

    def ranks(logical):
        entry = spec_for((logical,), layout.mesh, layout.rules)[0]
        return math.prod(sizes[a] for a in entry) if entry else 1
    _, counts = count_collectives(step, params, opt_state, batch)
    gathers, scatters = fsdp_gathers_per_step(layout, cfg)
    expect = []
    if gathers:
        expect += ["all_gather_into_tensor", "reduce_scatter_tensor"]
    if any(ranks(a) > 1 for a in TP_AXES):
        expect.append("all_reduce")
    findings = check_collectives(counts, program=program,
                                 expect_any=tuple(expect),
                                 expect_all=tuple(expect))
    logits = cfg.grad_accum if ranks("vocab") > 1 else 0
    for op, want in (("all_gather_into_tensor", gathers + logits),
                     ("reduce_scatter_tensor", scatters)):
        if counts.get(op, 0) != want:
            findings.append(Finding(
                "fsdp-gathers", program,
                f"{counts.get(op, 0)} {op} in one step, expected {want} "
                f"(FSDP weights x layers x microbatches x remat, "
                f"fsdp_gathers_per_step; {logits} logits gathers)"))
    return counts, findings

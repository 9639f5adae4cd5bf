"""Op-log rules: what aten ops may run inside one serve step of the port
(port of ``repro.statcheck.jaxpr_rules``).

The reference walks the closed jaxpr of each jitted serve program. The
port runs eagerly and has no jaxpr, so its rules read an **op log**: the
aten ops one call dispatched, recorded by ``OpLog`` (a
``TorchDispatchMode``) with the shapes, dtypes, devices and contiguity of
their tensor operands and outputs, and whether each op mutates an input or
returns a view. The port's kernels launch through ctypes and never reach
the dispatcher: their work does not appear in the log (the contracts read
the wrappers' ``.launches`` counters for them).

- ``no_pool_relayout``: no op makes a new tensor that relays out a
  pool-sized operand — a ``clone`` (``.contiguous()``, or a ``reshape``
  that cannot be a view) or a ``copy_`` from a non-contiguous view, a
  dtype conversion (``_to_copy``, ``copy_`` across dtypes), or a
  broadcast (``expand`` / ``repeat`` / ``repeat_interleave`` that grows
  its operand). Gathers (``index``, ``gather``, ``index_select``) and
  in-place writes of rows into the pool are not relayouts.
- ``no_host_sync``: no ``_local_scalar_dense`` (``.item()``, ``int(t)``,
  ``bool(t)``) and no op whose output lies on a device none of its inputs
  lies on (``.cpu()``, ``.to("cuda")`` of host data): each stalls the
  host on the card, and a CUDA graph cannot hold it.
- ``eq3_fold_present``: a ``cat`` whose last dim is ``head_dim + rank``,
  the signature of the Eq. 3 fold (one product of depth D + R).
- ``count_op``: the counterpart of ``count_primitive``.

Calibration, as the reference's: pool-sized means at least one per-layer
K/V slab of the live cache (``pool_threshold_for``), the SSM state leaves
where the family has no attention cache. Token-sized operands (the step's
q, k, v rows, the logits) sit far below it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["Finding", "TensorMeta", "OpRecord", "OpLog", "record",
           "no_pool_relayout", "no_host_sync", "eq3_fold_present",
           "count_op", "pool_threshold_for", "BROADCAST_OPS"]

# ops that materialize a broadcast of their first operand
BROADCAST_OPS = ("expand", "repeat", "repeat_interleave")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: which rule, where, and the offending op."""

    rule: str            # rule id, e.g. "no-pool-relayout"
    program: str         # logged program, e.g. "dense/decode[paged]"
    message: str         # human-readable diagnosis
    op: str = ""         # offending op (name + shapes), if any

    def __str__(self) -> str:
        loc = f" [{self.op}]" if self.op else ""
        return f"[{self.rule}] {self.program}: {self.message}{loc}"


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    contiguous: bool

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @classmethod
    def of(cls, t: torch.Tensor) -> "TensorMeta":
        return cls(tuple(t.shape), t.dtype, t.device, t.is_contiguous())


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: its tensor operands in argument order (so
    ``copy_``'s destination is ``inputs[0]``, its source ``inputs[1]``),
    its tensor outputs, and whether it writes an input / returns a view."""

    name: str
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    inplace: bool
    view: bool

    def __str__(self) -> str:
        ins = ",".join(str(t.shape) for t in self.inputs)
        outs = ",".join(str(t.shape) for t in self.outputs)
        return f"{self.name} {ins} -> {outs}"


class OpLog(TorchDispatchMode):
    """Records every aten op dispatched inside the ``with`` block in
    ``self.ops`` (the op runs as it would without the mode)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tensors = lambda tree: tuple(TensorMeta.of(t) for t in tree_leaves(
            tree) if isinstance(t, torch.Tensor))
        self.ops.append(OpRecord(
            name=func.overloadpacket.__name__,
            inputs=tensors((args, kwargs)), outputs=tensors(out),
            inplace=bool(func._schema.is_mutable),
            view=bool(getattr(func, "is_view", False))))
        return out


def record(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), [OpRecord])``: the call and its op log."""
    with OpLog() as log:
        out = fn(*args, **kwargs)
    return out, log.ops


def _relayout_source(op: OpRecord) -> Optional[TensorMeta]:
    """The operand ``op`` relays out into a new layout, dtype or size, or
    None where it does not."""
    if not op.inputs or not op.outputs:
        return None
    src = op.inputs[0]
    if op.name == "clone":
        return None if src.contiguous else src
    if op.name == "copy_" and len(op.inputs) > 1:
        dst, src = op.inputs[0], op.inputs[1]
        return src if not src.contiguous or src.dtype != dst.dtype else None
    if op.name == "_to_copy":
        return src if op.outputs[0].dtype != src.dtype else None
    if op.name in BROADCAST_OPS:
        return src if op.outputs[0].numel > src.numel else None
    return None


def no_pool_relayout(ops: Sequence[OpRecord], pool_threshold: int, *,
                     program: str = "decode") -> List[Finding]:
    """The decode-step tripwire: no op relays out an operand of at least
    ``pool_threshold`` elements (the smallest per-layer K/V slab). The
    kernel layout feeds the decode kernels zero-copy, so a clean step has
    none; a per-layer transpose of the pool to another layout and back (the
    reference's legacy adapters) has two per layer and cache."""
    if pool_threshold <= 0:
        raise ValueError(f"pool threshold {pool_threshold}")
    findings = []
    for op in ops:
        src = _relayout_source(op)
        if src is not None and src.numel >= pool_threshold:
            findings.append(Finding(
                rule="no-pool-relayout", program=program,
                message=(f"{op.name} relays out a pool-sized operand "
                         f"({src.numel} elems >= per-layer KV slab "
                         f"{pool_threshold}): Θ(pool) traffic per decoded "
                         f"token"),
                op=str(op)))
    return findings


def no_host_sync(ops: Sequence[OpRecord], *, program: str,
                 args_from_host: bool = False) -> List[Finding]:
    """No device-to-host read and no cross-device copy inside the step.
    ``args_from_host``: the program takes host arrays by design (the
    prefix cache's ``copy_pages``), so a copy from the CPU onto the card
    is its argument transfer, as a jitted program's arguments are, and
    only a read back to the host is flagged."""
    findings = []
    for op in ops:
        if op.name == "_local_scalar_dense":
            findings.append(Finding(
                rule="no-host-sync", program=program,
                message="a tensor read back as a host scalar (.item(), "
                        "int(t), bool(t)) inside the step",
                op=str(op)))
            continue
        ins = {t.device for t in op.inputs}
        moved = {t.device for t in op.outputs} - ins
        if args_from_host and all(d.type == "cpu" for d in ins):
            continue                     # the host arguments' transfer
        if ins and moved:
            findings.append(Finding(
                rule="no-host-sync", program=program,
                message=(f"{op.name} moves data from "
                         f"{sorted(map(str, ins))} to "
                         f"{sorted(map(str, moved))} inside the step"),
                op=str(op)))
    return findings


def eq3_fold_present(ops: Sequence[OpRecord], head_dim: int, rank: int, *,
                     program: str) -> List[Finding]:
    """FlashBias Eq. 3: the precision-free factored-bias path folds ``q
    k^T + phi_q phi_k^T`` into ONE product of depth ``D + R`` by
    concatenating the factors onto q and k (``core.attention
    .flashbias_concat_qk``); its op-log signature is a ``cat`` whose last
    dim is ``D + R``."""
    want = head_dim + rank
    if any(op.name == "cat" and op.outputs and op.outputs[0].shape
           and op.outputs[0].shape[-1] == want for op in ops):
        return []
    return [Finding(
        rule="eq3-fold", program=program,
        message=(f"no cat producing last dim {want} (= head_dim {head_dim} "
                 f"+ rank {rank}): the Eq. 3 single-product fold is missing "
                 f"from the precision-free factored-bias path"))]


def count_op(ops: Sequence[OpRecord], name: str,
             min_operand_size: int = 0) -> int:
    """How many ops ``name`` (with an operand of at least
    ``min_operand_size`` elements) the log holds."""
    return sum(1 for op in ops if op.name == name and max(
        (t.numel for t in op.inputs), default=0) >= min_operand_size)


def pool_threshold_for(cache: dict, n_layers: int,
                       kv_keys: Iterable[str] = ("k", "v", "pages_k",
                                                 "pages_v"),
                       fallback_keys: Iterable[str] = ("ssm_h", "conv_x",
                                                       "conv_bc"),
                       ) -> Optional[int]:
    """The pool-size threshold of ``no_pool_relayout`` from a live cache:
    the smallest per-layer K/V slab (the leaves lead with the layer axis
    and the step reads them a layer at a time), the SSM state leaves where
    there is no K/V; None where the cache has neither."""
    kv, fb = tuple(kv_keys), tuple(fallback_keys)
    sizes = [v.numel() // n_layers for k, v in cache.items() if k in kv]
    if not sizes:
        sizes = [v.numel() // n_layers for k, v in cache.items() if k in fb]
    return min(sizes) if sizes else None

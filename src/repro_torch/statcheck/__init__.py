"""repro_torch.statcheck — static contracts of the port's serve stack (port
of ``repro.statcheck``; README.md has the rule catalogue).

Three layers:

1. :mod:`repro_torch.statcheck.oplog_rules` +
   :mod:`repro_torch.statcheck.contracts` — log the aten ops of one decode
   step per cache family (a ``TorchDispatchMode``; the kernels, launched
   through ctypes, are read from their wrappers' ``.launches`` counters)
   and hold the log to the rules: no Θ(pool) relayout in the decode step,
   no host sync inside it, the Eq. 3 single-product fold on the
   precision-free factored-bias path, a bounded set of static-shape keys;
   ``verify_tripwire`` proves per run that the relayout rule still fires.
2. :mod:`repro_torch.statcheck.mesh_rules` — count the collectives of a
   sharded decode step under ``CommDebugMode``, hold the logical axes of
   the serve state to the ``Rules`` vocabulary, and report every state
   leaf that ``shard_put`` would replicate for a dim that does not divide
   its mesh axes; ``check_train_step`` counts one sharded train step's
   collectives and its FSDP gathers.
3. :mod:`repro_torch.statcheck.hostlint` — a stdlib-only AST lint of the
   host/device split (no ``torch`` in allocator and scheduler code, no
   bare asserts there, no hidden per-iteration syncs in the serve loop,
   clamped page-table reads in the kernel wrappers and, textually, in
   ``csrc/flash_decode.cu``).

Driven by ``scripts/run_statcheck_torch.py``. Only the op-log and mesh
layers import torch; ``hostlint`` imports the stdlib alone.
"""
from repro_torch.statcheck.mesh_rules import (
    COLLECTIVE_OPS,
    check_backend_mesh,
    check_collectives,
    check_shard_divisibility,
    check_state_axes,
    check_train_step,
    count_collectives,
    fsdp_gathers_per_step,
    shard_degradations,
)
from repro_torch.statcheck.oplog_rules import (
    Finding,
    OpLog,
    count_op,
    eq3_fold_present,
    no_host_sync,
    no_pool_relayout,
    pool_threshold_for,
    record,
)

__all__ = ["COLLECTIVE_OPS", "Finding", "OpLog", "check_backend_mesh",
           "check_collectives", "check_shard_divisibility",
           "check_state_axes", "check_train_step", "count_collectives",
           "count_op", "eq3_fold_present", "fsdp_gathers_per_step",
           "no_host_sync", "no_pool_relayout", "pool_threshold_for",
           "record", "shard_degradations"]

"""repro_torch.statcheck — checks of the port's serve stack (port of the
mesh layer of ``repro.statcheck``; the jaxpr, contract and host-lint
layers wait for ROADMAP Queue A item 10e).

:mod:`repro_torch.statcheck.mesh_rules` counts the collectives of a
sharded decode step under ``CommDebugMode``, holds the logical axes of the
serve state to the ``Rules`` vocabulary, and reports every state leaf that
``shard_put`` would replicate for a dim that does not divide its mesh axes;
``check_train_step`` counts one sharded train step's collectives and its
FSDP gathers.
"""
from repro_torch.statcheck.mesh_rules import (
    COLLECTIVE_OPS,
    Finding,
    check_backend_mesh,
    check_collectives,
    check_shard_divisibility,
    check_state_axes,
    check_train_step,
    count_collectives,
    fsdp_gathers_per_step,
    shard_degradations,
)

__all__ = ["COLLECTIVE_OPS", "Finding", "check_backend_mesh",
           "check_collectives", "check_shard_divisibility",
           "check_state_axes", "check_train_step", "count_collectives",
           "fsdp_gathers_per_step", "shard_degradations"]

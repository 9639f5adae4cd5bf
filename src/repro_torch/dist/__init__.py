"""repro_torch.dist — the sharding layer between model code and the mesh.

Templates name *logical* axes and this package resolves them against a
torch ``DeviceMesh``, as ``repro.dist`` resolves them against a jax mesh:
the same vocabulary and rules (``Rules``, ``spec_for``), placements as
DTensor ``Shard`` / ``Replicate`` per mesh dim (``placements_for``,
``shard_put``), and the ambient ``use_mesh_rules`` pair under which the
serve path runs its layers on local shards with the collectives of
``repro_torch.dist.collectives``. See ``README.md`` here for the mapping
from each JAX mechanism to its torch counterpart.
"""
from repro_torch.dist.sharding import (
    DEFAULT_RULES,
    Rules,
    batch_axes_for,
    constrain,
    degraded_spec,
    even_rules,
    get_active_mesh,
    grad_sum_axes,
    mesh_axis_sizes,
    placements_for,
    shard_put,
    spec_for,
    split_axes,
    use_mesh_rules,
)

__all__ = ["Rules", "spec_for", "batch_axes_for", "use_mesh_rules",
           "get_active_mesh", "constrain", "shard_put", "DEFAULT_RULES",
           "mesh_axis_sizes", "placements_for", "degraded_spec",
           "even_rules", "split_axes", "grad_sum_axes"]

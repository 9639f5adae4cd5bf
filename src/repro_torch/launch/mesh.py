"""Production mesh construction (a FUNCTION: importing this module touches
no process group)."""
from __future__ import annotations

__all__ = ["make_production_mesh", "GPUS_PER_NODE"]

GPUS_PER_NODE = 8          # an H100 node: 8 cards joined all to all by NVLink


def make_production_mesh(*, multi_pod: bool = False):
    """The serving / training mesh over every rank of the initialised
    process group, for H100 nodes of ``GPUS_PER_NODE`` cards.

    Single pod: ``(world // 8, 8)`` as ``(data, model)``, so tensor
    parallelism (the ``model`` axis: heads, kv heads, FFN hidden, vocab,
    experts) stays inside one node's NVLink domain and only the data axis
    crosses nodes. Multi-pod: ``(2, world // 16, 8)`` as ``(pod, data,
    model)``; the ``pod`` axis folds into the DP product (``batch`` ->
    ``("pod", "data")``). The shape is the port's own choice for H100
    nodes, not the reference's TPU pod shape."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    pods = 2 if multi_pod else 1
    if world % (pods * GPUS_PER_NODE):
        raise ValueError(f"a world of {world} ranks is not {pods} pod(s) of "
                         f"whole {GPUS_PER_NODE}-card nodes")
    data = world // (pods * GPUS_PER_NODE)
    if multi_pod:
        return init_device_mesh("cuda", (pods, data, GPUS_PER_NODE),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cuda", (data, GPUS_PER_NODE),
                            mesh_dim_names=("data", "model"))

"""Production mesh construction (a FUNCTION: importing this module touches
no process group)."""
from __future__ import annotations

import math
import os

__all__ = ["make_production_mesh", "init_mesh", "GPUS_PER_NODE"]

GPUS_PER_NODE = 8          # an H100 node: 8 cards joined all to all by NVLink


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The serving / training mesh over every rank of the initialised
    process group, for H100 nodes of ``GPUS_PER_NODE`` cards.

    Single pod: ``(world // 8, 8)`` as ``(data, model)``, so tensor
    parallelism (the ``model`` axis: heads, kv heads, FFN hidden, vocab,
    experts) stays inside one node's NVLink domain and only the data axis
    crosses nodes. Multi-pod: ``(2, world // 16, 8)`` as ``(pod, data,
    model)``; the ``pod`` axis folds into the DP product (``batch`` ->
    ``("pod", "data")``). The shape is the port's own choice for H100
    nodes, not the reference's TPU pod shape. ``device_type`` is the
    mesh's (``"cpu"`` for the dry run's fake process group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    pods = 2 if multi_pod else 1
    if world % (pods * GPUS_PER_NODE):
        raise ValueError(f"a world of {world} ranks is not {pods} pod(s) of "
                         f"whole {GPUS_PER_NODE}-card nodes")
    data = world // (pods * GPUS_PER_NODE)
    if multi_pod:
        return init_device_mesh(device_type, (pods, data, GPUS_PER_NODE),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, GPUS_PER_NODE),
                            mesh_dim_names=("data", "model"))


def init_mesh(spec: str, init_method: str, device, *,
              names=(("data", "model"), ("pod", "data", "model"))):
    """The mesh of ``--mesh DxM`` (``(data, model)``) or ``PxDxM``
    (``(pod, data, model)``, where ``names`` allows it) over the ranks of
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``):
    NCCL on the card (each rank on its ``LOCAL_RANK`` card), ``gloo`` on
    the CPU. A process group already initialised is used as it is. Returns
    (mesh, rank, this rank's device, whether this call initialised the
    group); a ValueError for a spec or a world that does not fit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    try:
        shape = tuple(int(v) for v in spec.lower().split("x"))
    except ValueError:
        shape = ()
    dims = {len(n): n for n in names}
    if len(shape) not in dims:
        forms = " or ".join("x".join(n[0].upper() for n in d)
                            for d in names)
        raise ValueError(f"--mesh {spec!r}: expected {forms}, e.g. 2x2")
    size = math.prod(shape)
    started = not dist.is_initialized()
    world = (int(os.environ.get("WORLD_SIZE", "1")) if started
             else dist.get_world_size())
    if world != size:
        raise ValueError(f"--mesh {spec} needs a world of {size} ranks "
                         f"(torchrun --nproc-per-node {size}), found {world}")
    rank = (int(os.environ.get("RANK", "0")) if started
            else dist.get_rank())
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        torch.cuda.set_device(device)
    if started:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world)
    mesh = init_device_mesh(device.type, shape,
                            mesh_dim_names=dims[len(shape)])
    return mesh, rank, device, started

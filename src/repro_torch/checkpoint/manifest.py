"""Atomic, manifest-based checkpoints in the reference's on-disk format
(port of ``repro.checkpoint.manifest``), so a checkpoint written by either
package restores in the other::

    <dir>/step_000123/
        manifest.json        # step, extras, leaves [{name, file, shape, dtype}]
        leaf_00000.npy       # one file per leaf (the global array)
        ...

- A save writes ``step_X.tmp-<pid>`` and renames it, so a crash mid-save
  never corrupts the latest checkpoint; ``keep_n`` prunes older steps after
  the rename.
- Leaves are named by their path as the reference's JAX tree flattening
  names them: dict keys in sorted order, tuple and list items and
  ``OptState`` fields (step, mu, nu, err) by index, None skipped. So
  ``(params, opt_state)`` gives ``0/embed``, ``0/layers/attn/wq``, ...,
  ``1/0`` (the step), ``1/1/...`` (mu), ``1/2/...`` (nu).
- bfloat16 leaves, which numpy lacks, are stored as their ``u2`` bits with
  the logical dtype in the manifest, and restored bit-exactly.
- Sharded runs (DTensor leaves, e.g. ``TrainLayout.dtensors`` of the local
  shards): every rank takes part in each leaf's gather, rank 0 alone
  writes the GLOBAL array in the same format, and all ranks meet at a
  barrier once the step is renamed into place. A restore whose template
  holds DTensors puts each global leaf onto the template's mesh and
  placements, whatever mesh wrote it: a run saved on ``(2, 2)`` restores
  onto ``(1, 2)``, ``(2, 1)`` or no mesh (the elastic restore of the
  reference's ``restore_checkpoint(..., shardings=)``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "all_steps"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32,
                 "int64": torch.int64, "uint8": torch.uint8,
                 "bool": torch.bool}


def _children(tree):
    """(key, child) pairs of a tree node, in the reference's flattening
    order; None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(i, getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _flatten_with_names(tree, prefix: str = ""):
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _flatten_with_names(child, f"{prefix}/{key}" if prefix
                                   else str(key))
    return out


def _unflatten(tree, values: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[name]``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return values[prefix]
    new = {key: _unflatten(child, values, f"{prefix}/{key}" if prefix
                           else str(key)) for key, child in kids}
    if isinstance(tree, dict):
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(new[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **{
        f.name: new[i] for i, f in enumerate(dataclasses.fields(tree))})


def _to_numpy(leaf):
    """(array to save, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) not in np.sctypeDict:
        # extension dtypes (ml_dtypes' bfloat16, float8_*): raw bits
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), str(arr.dtype)
    return arr, str(arr.dtype)


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extras: Optional[dict] = None, keep_n: int = 3) -> str:
    """Save ``tree`` (nested dicts, tuples, lists and dataclasses of
    tensors, arrays or scalars) atomically. Returns the step's path. With
    DTensor leaves every rank must call it: the leaves are gathered, rank
    0 writes, and the ranks return together."""
    leaves = _flatten_with_names(tree)
    sharded = any(_is_dtensor(leaf) for _, leaf in leaves)
    writer = True
    if sharded:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "extras": extras or {},
                "treedef": f"repro_torch: {len(leaves)} leaves",
                "leaves": []}
    for i, (name, leaf) in enumerate(leaves):
        if _is_dtensor(leaf):
            with torch.no_grad():
                leaf = leaf.full_tensor()         # a collective: all ranks
        if not writer:
            continue
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": dtype_name})
        del leaf, arr
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in sorted(all_steps(directory))[:-keep_n]:
            shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                          ignore_errors=True)
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    return final


def all_steps(directory: str) -> list:
    """The committed steps under ``directory`` (temporaries excluded)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and ".tmp-" not in d:
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype_name in _TORCH_DTYPES:
        t = torch.from_numpy(arr.view(np.dtype(dtype_name)))
    else:
        raise ValueError(f"checkpoint leaf dtype {dtype_name!r} has no "
                         f"torch counterpart here")
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore_checkpoint(directory: str, step: Optional[int], template: Any):
    """Restore into the structure of ``template`` (its leaves give the
    names, global shapes and devices, and a DTensor leaf its mesh and
    placements: the restored leaf is then a DTensor holding this rank's
    shard of the global array; the dtypes are the manifest's). ``step``
    None takes the latest. Returns (tree, extras)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tmpl = dict(_flatten_with_names(template))
    by_name = {e["name"]: e for e in manifest["leaves"]}
    if set(tmpl) != set(by_name):
        raise ValueError(f"checkpoint/template structure mismatch: missing="
                         f"{sorted(set(tmpl) - set(by_name))} extra="
                         f"{sorted(set(by_name) - set(tmpl))}")
    values = {}
    for name, like in tmpl.items():
        entry = by_name[name]
        arr = np.load(os.path.join(path, entry["file"]))
        if hasattr(like, "shape") and tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {arr.shape} != template "
                             f"{tuple(like.shape)}")
        values[name] = _from_numpy(arr, entry["dtype"], like)
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor
            values[name] = distribute_tensor(values[name], like.device_mesh,
                                             like.placements,
                                             src_data_rank=None)
    return _unflatten(template, values), manifest["extras"]

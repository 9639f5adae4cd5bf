"""The dry run: the port's own step of every (arch x shape x mesh) cell,
run on the host on fake tensors, measured per rank (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder devices
and reads XLA's memory and cost analyses. The port has no compiler: it
runs the same eager code a rank runs, on ``FakeTensorMode`` tensors, in a
fake process group of 256 ranks (the single-pod ``(32, 8)`` mesh) or 512
(``(2, 32, 8)``). Nothing is allocated at model scale and nothing is
computed: parameters come from ``models.common.materialize`` and are cut
to this rank's shards as the train layout (``TrainLayout.shard``) or the
serve layout (``serve.backend``'s ``shard_params``) cuts them; a decode
cell's cache is built by ``init_cache`` and placed by the serve backend's
state axes. Per cell it records, for rank 0:

- memory: ``MemTracker``, with the parameters, optimizer state, cache and
  batch registered through ``track_external``: argument bytes (those
  inputs), peak bytes, temporary bytes (peak minus arguments) and output
  bytes;
- ``FlopCounterMode``'s FLOPs;
- bytes: operand and result bytes of every aten op that reads or writes
  storage, views skipped (the eager counterpart of XLA's "bytes
  accessed");
- the functional collectives ``dist/collectives.py`` issues: op, result
  bytes, group size and mesh axes (``analysis.collective_bytes``);
- the kernels' terms under ``impl="io_stub"`` (``kernels.io_stub``):
  calls, bytes read and written once, tile re-reads and FLOPs.

The plain path (``attn_impl="torch"``) gives the raw terms; the
``io_stub`` run gives the deployment terms (its aten FLOPs and bytes plus
the kernels'), as the reference adjusts its cost lowering with its
io_stub. ``roofline_report`` takes both, on ``hw.H100_SXM``. The layers
are a Python loop (``models/lm.py``), so every layer is counted: there is
no extrapolation from one and two layers and no twin of the reference's
``flags.py``. The multi-pod pass runs the deployment path only, for its
memory; ``--mesh node`` runs one node's ``(1, 8)``. Every train cell runs
at its config's ``grad_accum``: where a microbatch's rows do not divide
the ``batch`` ranks, rank 0 takes one of the rows a rank takes at most
(``make_train_step``), and a rank with none runs a padding row, as
GSPMD's padded step does. A cell that fails is listed and the run exits
1.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single multi --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import types
from typing import Optional

import torch

from repro_torch.analysis.roofline import (attention_kernel_flops,
                                           attention_kv_reread_bytes,
                                           collective_bytes, roofline_report)
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.sharding import Rules
from repro_torch.hw import H100_SXM
from repro_torch.kernels import io_stub
from repro_torch.kernels.io_stub import KERNEL1_TILE

__all__ = ["run_cell", "run_step", "prepare", "measure", "tensors",
           "deployment_terms", "resident_bytes", "storage_bytes", "CUDA_BLOCK",
           "fake_world", "release_world",
           "production_mesh", "fake_mesh", "main"]

# functional collective op -> the reference's HLO name
_COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def tensors(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists."""
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter:
    """A dispatch mode's state: bytes of the ops that touch storage and the
    collectives issued (``_CountMode``)."""

    def __init__(self):
        self.bytes = 0
        self.collectives = []        # (op, result bytes, group size, axes)


def _count_mode(counter: _Counter):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if func.namespace == "_c10d_functional" and \
                    name in _COLLECTIVE_NAMES:
                _record_collective(counter, name, args, out)
            # prim ops (``prim.device`` of a fake tensor) read metadata
            if not func.is_view and func.namespace != "prim":
                counter.bytes += sum(_nbytes(t) for t in tensors(
                    (args, kwargs, out)))
            return out
    return _CountMode()


def _record_collective(counter: _Counter, name: str, args, out) -> None:
    from torch.distributed.distributed_c10d import _resolve_process_group
    group_name = next(a for a in reversed(args) if isinstance(a, str))
    size = _resolve_process_group(group_name).size()
    rb = sum(_nbytes(t) for t in tensors(out))
    counter.collectives.append((_COLLECTIVE_NAMES[name], rb, size,
                                _group_axes(group_name)))


def _group_axes(group_name: str) -> Optional[tuple]:
    """The mesh axes (major to minor) of the process group ``group_name``,
    among the groups ``dist.collectives`` has built (its cache is keyed by
    the axes); None for any other group."""
    from repro_torch.dist import collectives as C
    for (_, axes), (mesh, found) in C._MESH_GROUPS.items():
        if found is not None:
            group = found[0]
            pg = (group[0].get_group(group[1]) if isinstance(group, tuple)
                  else group.get_group())
            if pg.group_name == group_name:
                return axes
    return None


# the CUDA caching allocator's smallest block: ``MemTracker`` rounds each
# CUDA storage up to it, and ``measure`` rounds the arguments alike
CUDA_BLOCK = 512


def storage_bytes(tensors, block: int = 1) -> int:
    """Bytes of the distinct storages behind ``tensors``, each rounded up
    to a multiple of ``block``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = -(-st.nbytes() // block) * block
    return sum(seen.values())


def measure(fn, externals, device) -> dict:
    """Run ``fn()`` once under the counting modes, ``externals`` (the
    step's inputs: parameters, optimizer state, cache, batch) registered
    with ``MemTracker``. Returns {"flops", "bytes", "collectives",
    "kernels", "memory": {argument, output, temp, peak bytes}, "out"}; on
    a CUDA device each storage counts whole blocks of ``CUDA_BLOCK``
    bytes. The peak is the step's own: ``resident_bytes`` names what a
    card process holds beside it."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    ext = tensors(externals)
    tracker = MemTracker()
    tracker.track_external(*ext)
    counter = _Counter()
    io_stub.reset()
    with tracker, FlopCounterMode(display=False) as flops, \
            _count_mode(counter):
        out = fn()
    kind = torch.device(device).type
    block = CUDA_BLOCK if kind == "cuda" else 1
    peak = sum(v.get("Total", 0) for d, v in
               tracker.get_tracker_snapshot("peak").items()
               if d.type == kind)
    argument = storage_bytes(ext, block)
    ext_ids = {t.untyped_storage()._cdata for t in ext}
    outs = [t for t in tensors(out)
            if t.untyped_storage()._cdata not in ext_ids]
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes),
            "collectives": counter.collectives,
            "kernels": io_stub.terms(),
            "memory": {"argument_bytes": argument,
                       "output_bytes": storage_bytes(outs, block),
                       "temp_bytes": peak - argument,
                       "peak_bytes": peak},
            "out": out}


# torch's cuBLAS workspace on a compute capability 9.x card: 4096 KiB x 8,
# the default ``CUBLAS_WORKSPACE_CONFIG`` there
CUBLAS_WORKSPACE_BYTES = 8 * 4096 * 1024


def resident_bytes(*, gemm_threads: int, decode_rows: int = 0) -> int:
    """What a card process holds beside its steps' tensors, made by its
    first steps through the caching allocator and kept: a cuBLAS
    workspace for each thread that has run a GEMM (torch keeps one per
    cuBLAS handle and stream, and each thread has its own handle: 1 for
    serving, 2 once a backward has run on the autograd engine's device
    thread), and, once a decode kernel has run, its arrival counters for
    ``decode_rows`` (batch x kv heads) rows (``flash_decode._arrivals``).
    The dry run's peaks leave these out."""
    from repro_torch.kernels.flash_decode import MIN_ARRIVALS
    arrivals = 4 * max(decode_rows, MIN_ARRIVALS) if decode_rows else 0
    return gemm_threads * CUBLAS_WORKSPACE_BYTES + arrivals


# ---------------------------------------------------------------------------
# Process group and meshes
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0 (one made
    for another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        release_world()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def release_world() -> None:
    """Tear down the process group and the groups the collectives cached
    on its meshes."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as C
    if dist.is_initialized():
        dist.destroy_process_group()
    C._GROUPS.clear()
    C._MESH_GROUPS.clear()


def production_mesh(multi_pod: bool):
    """The port's ``(32, 8)`` or ``(2, 32, 8)`` mesh on a fake group."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` (``names``) on a fake group of its
    size (the hill climb's re-factored meshes, the tests' small ones)."""
    import math
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _mesh_size(mesh, name: str) -> int:
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


# ---------------------------------------------------------------------------
# One step of a cell
# ---------------------------------------------------------------------------

def _decode_state_axes(model) -> dict:
    """The serve backend's logical axes of a contiguous cache."""
    from repro_torch.serve.backend import TokenDecodeBackend
    view = types.SimpleNamespace(model=model, paged=False)
    return TokenDecodeBackend._state_axes(view)


def prepare(cfg, shape: ShapeSpec, mesh, rules: Rules, device, *,
            fake: bool = True, seed: int = 0):
    """(fn, externals, ambient context) of one cell's step on this rank,
    built under the caller's mode (``fake``: a fake mode, the weights drawn
    by a CPU generator; else real tensors on ``device``, drawn there):
    ``fn()`` runs the step (train: ``make_train_step``'s, returning the
    loss; prefill: ``Model.prefill``; decode: ``Model.decode``, both under
    ``no_grad``) and ``externals`` are its inputs."""
    from repro_torch.dist.collectives import local_range
    from repro_torch.dist.sharding import shard_put, use_mesh_rules
    from repro_torch.models.api import get_model
    from repro_torch.models.common import materialize, shard_params, tree_map
    model = get_model(cfg)
    gen = torch.Generator(device="cpu" if fake else device)
    gen.manual_seed(seed)
    params = materialize(model.template(), gen, device=device)
    specs = model.input_specs(shape, device=device)
    if shape.kind == "train":
        from repro_torch.optim import AdamW
        from repro_torch.optim.schedules import constant
        from repro_torch.train.step import make_train_step
        opt = AdamW(lr_fn=constant(1e-4))
        step = make_train_step(model.loss, opt, grad_accum=cfg.grad_accum,
                               mesh=mesh, rules=rules,
                               template=model.template())
        if step.layout is not None:
            params = step.layout.shard(params)
        state = opt.init(params)

        def fn():
            return step(params, state, specs)[2]["loss"]
        return fn, (params, state.mu, state.nu, state.step, specs), \
            contextlib.nullcontext()

    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: the {cfg.family} family runs the "
                         f"train cells only")
    from repro_torch.models.lm import cast_layers
    params = cast_layers(params, cfg)
    ctx = contextlib.nullcontext()
    b = shape.global_batch
    if mesh is not None:
        from repro_torch.serve.backend import _serve_template, serve_rules
        tmpl = _serve_template(model.template())
        srules = serve_rules(tmpl, mesh, rules, b)
        params = tree_map(lambda d: d.to_local(),
                          shard_params(params, tmpl, mesh, srules))
        with use_mesh_rules(mesh, srules):
            rows = local_range(b, "batch")   # serve_rules made it divide
        if shape.kind == "decode":
            axes = _decode_state_axes(model)
            specs["cache"] = {k: shard_put(v, mesh, srules,
                                           axes[k]).to_local()
                              for k, v in specs["cache"].items()}
            specs["tokens"] = shard_put(specs["tokens"], mesh, srules,
                                        ("batch", None)).to_local()
        else:
            specs = {k: v[rows] for k, v in specs.items()}
        ctx = use_mesh_rules(mesh, srules)

    if shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                return model.prefill(params, specs, max_len=shape.seq_len)
        return fn, (params, specs), ctx

    cache, tokens = specs["cache"], specs["tokens"]

    def fn():
        with torch.no_grad():
            return model.decode(params, cache, tokens)
    return fn, (params, cache, tokens), ctx


def run_step(cfg, shape: ShapeSpec, mesh, rules: Rules, *,
             device="cpu", fake: bool = True, seed: int = 0) -> dict:
    """``measure`` of one cell's step on rank 0, on fake tensors (or, with
    ``fake=False``, real ones: small configs only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    t0 = time.monotonic()
    with mode:
        fn, externals, ctx = prepare(cfg, shape, mesh, rules, device,
                                     fake=fake, seed=seed)

        def run():
            with ctx:
                return fn()
        res = measure(run, externals, device)
    res["seconds"] = time.monotonic() - t0
    return res


def deployment_terms(step: dict) -> tuple:
    """(FLOPs, bytes) of an ``io_stub`` step (``run_step``): its aten ops'
    plus its kernels' (each input read once, the output written once, the
    tile re-reads)."""
    k = step["kernels"].values()
    return (step["flops"] + sum(v["flops"] for v in k),
            step["bytes"] + sum(v["bytes"] + v["reread_bytes"] for v in k))


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             rules: Rules = Rules(), verbose: bool = True,
             cfg_override=None, with_cost: bool = True,
             mesh_override=None, mesh_name: Optional[str] = None) -> dict:
    """One dry-run cell (the hill climb's hooks: ``cfg_override``,
    ``rules`` and ``mesh_override``, named ``mesh_name`` in the report)."""
    cfg = cfg_override or get_config(arch_id)
    shape = SHAPES[shape_name]
    mesh = mesh_override or production_mesh(multi_pod)
    n_dev = mesh.size()
    mesh_tag = mesh_name or ("multi" if multi_pod else "single")
    t0 = time.monotonic()
    adj = run_step(cfg.replace(attn_impl="io_stub"), shape, mesh, rules)
    kernels = adj["kernels"]
    base = {"arch": cfg.name, "arch_id": arch_id, "shape": shape.name,
            "mesh": mesh_tag, "devices": n_dev,
            "mesh_shape": list(mesh.shape),
            "memory": adj["memory"], "kernels": kernels,
            "io_stub_aten_flops": adj["flops"],
            "io_stub_aten_bytes": adj["bytes"],
            "hbm_bytes": H100_SXM.hbm_bytes, "ok": True,
            "grad_accum": cfg.grad_accum}
    if not with_cost:
        base["run_s"] = time.monotonic() - t0
        if verbose:
            print(f"[dryrun] {arch_id} x {shape.name} x {mesh_tag}: "
                  f"{base['run_s']:.1f}s, peak/rank "
                  f"{adj['memory']['peak_bytes'] / 2**30:.2f} GiB")
        return base
    raw = run_step(cfg.replace(attn_impl="torch"), shape, mesh, rules)
    coll = collective_bytes(raw["collectives"])
    adj_coll = collective_bytes(adj["collectives"])
    adj_flops, adj_bytes = deployment_terms(adj)
    n_model = _mesh_size(mesh, "model")
    n_data = n_dev // n_model
    report = roofline_report(
        flops_per_device=raw["flops"], bytes_per_device=raw["bytes"],
        coll_bytes_per_device=adj_coll["total"], cfg=cfg, shape=shape,
        n_devices=n_dev, coll_detail=adj_coll,
        coll_bytes_by_axis=adj_coll["by_axis"],
        adjusted_bytes_per_device=adj_bytes,
        adjusted_flops_per_device=adj_flops)
    report.update(base)
    report.update(
        run_s=time.monotonic() - t0,
        memory_plain=raw["memory"], collective_detail_plain=coll,
        # the reference's analytic attention terms at the port kernel's
        # own tiles, beside the stub's exact count
        attention_block=KERNEL1_TILE[0],
        analytic_attention_flops=attention_kernel_flops(
            cfg, shape, n_data, n_model, block=KERNEL1_TILE[0]),
        analytic_kv_reread_bytes=attention_kv_reread_bytes(
            cfg, shape, n_data, block=KERNEL1_TILE[0]))
    if verbose:
        print(f"[dryrun] {arch_id} x {shape.name} x {mesh_tag}: "
              f"{report['run_s']:.1f}s  flops/rank {adj_flops:.3e}  "
              f"bytes/rank {adj_bytes:.3e}  coll/rank "
              f"{adj_coll['total']:.3e}  dominant={report['dominant']}  "
              f"peak/rank {adj['memory']['peak_bytes'] / 2**30:.2f} GiB")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi", "node"],
                    help="single: (32, 8); multi: (2, 32, 8), memory only; "
                         "node: (1, 8), one node of 8 cards")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--sp", action="store_true",
                    help="the reference's sequence-parallel rules; refused: "
                         "the port's models do not split the sequence")
    args = ap.parse_args(argv)
    if args.sp:
        ap.error("--sp: no port code reads the 'seq' axis, so the cells "
                 "would equal the plain run's (ROADMAP.md, Queue A 10f)")

    grid = cells()
    if args.arch != ["all"]:
        grid = [(a, s) for a, s in grid if a in args.arch]
    if args.shape != ["all"]:
        grid = [(a, s) for a, s in grid if s in args.shape]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.monotonic()
    for name in args.mesh:
        for arch_id, shape_name in grid:
            tag = f"{arch_id}.{shape_name}.{name}"
            try:
                node = fake_mesh((1, 8), ("data", "model")) \
                    if name == "node" else None
                rep = run_cell(arch_id, shape_name,
                               multi_pod=name == "multi",
                               with_cost=name != "multi", mesh_override=node,
                               mesh_name=name)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rep, f, indent=1, default=str)
            except Exception:
                failures.append(tag)
                traceback.print_exc()
                print(f"[dryrun] FAILED {tag}")
    print(f"[dryrun] done in {time.monotonic() - t0:.1f}s; "
          f"{len(failures)} failures: {failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

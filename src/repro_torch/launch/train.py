"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``repro.launch.train``).

Trains an LM config through the fault-tolerant loop on synthetic
``LMBatches`` (frontend rows included for the frontend configs): float32
master weights made from ``--seed`` by ``init_params``, compute in the
config's dtype, AdamW with a cosine or WSD schedule, ``--grad-accum``
microbatches (default: the config's), checkpoints under ``--ckpt-dir``
every ``--ckpt-every`` steps (a rerun with the same directory resumes),
one JSON line per step in ``--log``. Runs on the CUDA device unless
``--device cpu`` is given.

``--mesh DxM`` (``(data, model)``) or ``PxDxM`` (``(pod, data, model)``)
trains on a DeviceMesh over torchrun's ranks (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; ``--init-method``, default ``env://``, or a file
rendezvous): NCCL on the cards, one per rank, ``gloo`` with ``--device
cpu``. Every rank makes the same float32 masters from ``--seed`` and
keeps its shards (``TrainLayout``: FSDP over ``data``, tensor parallelism
over ``model``, the batch over ``pod`` x ``data``), builds the same global
batch and trains its rows; checkpoints hold global leaves, so a run
resumes on any mesh, or none. Only rank 0 writes the log and prints the
final line.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import LMBatches
from repro_torch.models import get_model, init_params
from repro_torch.optim import AdamW, cosine, wsd
from repro_torch.serve import resolve_device
from repro_torch.train import TrainLoop, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM: train on a (data, model) or (pod, "
                         "data, model) mesh of D*M (P*D*M) ranks")
    ap.add_argument("--init-method", default="env://",
                    help="process-group rendezvous of --mesh (torchrun's "
                         "env:// or file:///path)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    if model.loss is None or cfg.family not in ("dense", "moe", "ssm",
                                                "hybrid"):
        raise SystemExit(f"{args.arch}: the launcher trains the LM "
                         f"families only")
    device = resolve_device(args.device)
    mesh, rank, started = None, 0, False
    if args.mesh:
        from repro_torch.launch.mesh import init_mesh
        try:
            mesh, rank, device, started = init_mesh(args.mesh,
                                                    args.init_method, device)
        except ValueError as e:
            ap.error(str(e))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)

    if args.schedule == "wsd":   # minicpm's schedule
        lr_fn = wsd(args.lr, args.steps // 10, int(args.steps * 0.7),
                    args.steps - args.steps // 10 - int(args.steps * 0.7))
    else:
        lr_fn = cosine(args.lr, args.steps // 10, args.steps)
    opt = AdamW(lr_fn=lr_fn)
    grad_accum = args.grad_accum or cfg.grad_accum
    step_fn = make_train_step(model.loss, opt, grad_accum=grad_accum,
                              mesh=mesh, template=model.template())
    if step_fn.layout is not None:
        params = step_fn.layout.shard(params)
    opt_state = opt.init(params)

    data = LMBatches(vocab=cfg.vocab, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed,
                     frontend_len=cfg.frontend_len, d_model=cfg.d_model)

    def data_fn(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.batch(step).items()}

    loop = TrainLoop(step_fn, data_fn, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, log_path=args.log)
    params, opt_state, info = loop.run(params, opt_state, args.steps,
                                       shardings=step_fn.layout)
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()
    if rank == 0:
        where = device if mesh is None else (
            f"{device.type} mesh {args.mesh} "
            f"({', '.join(mesh.mesh_dim_names)})")
        print(f"[train] {cfg.name} on {where}: {info}")
    return info


if __name__ == "__main__":
    main()

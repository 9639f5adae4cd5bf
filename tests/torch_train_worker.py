"""One rank of a multi-process CPU run of the port's sharded train step
(``gloo``; not collected by pytest: the name lacks ``test_``).

    python tests/torch_train_worker.py --init file:///tmp/x --rank 0 \
        --world 4 --mesh 2x2 --params DIR --out DIR --jobs a,b

Every rank loads the same parameters (``DIR/<arch>.npz``: the port's
``init_params``, saved by the caller, which loads the same arrays into
the unsharded step and the reference), keeps its shards
(``TrainLayout``) and trains them through ``make_train_step(mesh=)`` on
the same global ``LMBatches``. Rank 0 writes ``out/<job>.npz``: the
losses and gradient norms of each step, the gradients of step 0 and the
parameters after the last step, gathered to global arrays. Jobs:

- ``train:<case>``: ``STEPS`` steps of a case of ``CASES``;
- ``control:<case>``: one step with *g*'s backward replaced by the
  summing all-reduce of the functional collectives' own autograd (the
  gradients must then miss the unsharded ones);
- ``statcheck:<case>``: one step under ``CommDebugMode``, its counts and
  ``check_train_step``'s findings, and the bytes of this rank's local
  masters and optimizer state before the step;
- ``save:<case>``: ``TrainLoop`` with a checkpoint after step 1, then step 2
  without one (the uninterrupted run);
- ``restore:<case>``: wait for ``save``'s checkpoint (``--ckpt``), restore
  it through ``TrainLoop`` on this mesh and run step 2.

Every rank writes ``out/rank<R>.json`` with its jobs' status and small
results.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS = 2
BATCH, SEQ, LR = 8, 16, 1e-3
# case -> (arch, config overrides). attn_impl "cuda" takes attention
# through ops._FlashAttention and kernel 1's wrapper, which runs its plain
# version on a CPU tensor: its checks then see the local heads and rows
# (ssd_scan's "cuda" refuses a CPU tensor, so the SSM families keep "auto")
CASES = {
    "gpt2": ("gpt2_alibi_15b", {"grad_accum": 2, "remat": "dots",
                                "attn_impl": "cuda"}),
    # the production compute dtype: bf16 gathers and tensor-parallel sums
    "gpt2bf16": ("gpt2_alibi_15b", {"grad_accum": 2, "remat": "dots",
                                    "attn_impl": "cuda",
                                    "dtype": "bfloat16"}),
    "stablelm": ("stablelm_12b", {"attn_impl": "cuda"}),
    "codeqwen": ("codeqwen15_7b", {}),
    "granite": ("granite_moe_3b_a800m", {}),
    "mamba2": ("mamba2_130m", {}),
    "hymba": ("hymba_15b", {}),
}


def case_config(case: str):
    from repro_torch.configs import smoke_config
    arch, kw = CASES[case]
    return smoke_config(arch).replace(**kw)


def batch(cfg, step: int) -> dict:
    """The global batch of ``step`` (every rank builds the same)."""
    import torch
    from repro_torch.data import LMBatches
    data = LMBatches(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=0)
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


def load_params(params_dir: str, case: str):
    from repro_torch.interop import params_from_numpy
    flat = np.load(Path(params_dir) / f"{CASES[case][0]}.npz")
    tree: dict = {}
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return params_from_numpy(tree, case_config(case), device="cpu")


class Recorder:
    """An AdamW whose ``update`` keeps the gradients it is given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        self.grads.append({k: v for k, v in _flat(grads).items()})
        return self.opt.update(grads, state, params, **kw)


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def optimizer():
    from repro_torch.optim import AdamW, constant
    # eps 1: the update is smooth in the gradient, so the parameters after
    # the steps show the gradients' agreement (tests/test_torch_train.py)
    return Recorder(AdamW(lr_fn=constant(LR), eps=1.0))


def setup(case: str, mesh, params_dir: str):
    from repro_torch.models import get_model
    from repro_torch.train import make_train_step
    cfg = case_config(case)
    model = get_model(cfg)
    opt = optimizer()
    step = make_train_step(model.loss, opt, grad_accum=cfg.grad_accum,
                           mesh=mesh, template=model.template())
    params = step.layout.shard(load_params(params_dir, case))
    return cfg, step, opt, params


def gathered(layout, tree: dict) -> dict:
    """{path: global numpy array} of a tree of local shards."""
    import torch
    with torch.no_grad():
        return {k: v.full_tensor().numpy()
                for k, v in _flat(layout.dtensors(tree)).items()}


def job_train(case: str, mesh, params_dir: str, steps: int = STEPS) -> dict:
    cfg, step, opt, params = setup(case, mesh, params_dir)
    state = opt.init(params)
    losses, norms = [], []
    for i in range(steps):
        params, state, m = step(params, state, batch(cfg, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    arrays = {f"grad:{k}": v for k, v in gathered(
        step.layout, _nest(opt.grads[0])).items()}
    arrays.update({f"param:{k}": v
                   for k, v in gathered(step.layout, params).items()})
    arrays["losses"], arrays["norms"] = np.array(losses), np.array(norms)
    return {"arrays": arrays, "losses": losses, "norms": norms}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def job_control(case: str, mesh, params_dir: str) -> dict:
    """One step with *g*'s backward summing over the ranks."""
    from repro_torch.dist import collectives as C
    orig = C._ReduceFrom

    class Summing(orig):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return C._all_reduce(x, group)

        @staticmethod
        def backward(ctx, grad):
            return C._all_reduce(grad, ctx.group), None
    C._ReduceFrom = Summing
    try:
        return job_train(case, mesh, params_dir, steps=1)
    finally:
        C._ReduceFrom = orig


def job_statcheck(case: str, mesh, params_dir: str) -> dict:
    from repro_torch.statcheck import check_train_step
    cfg, step, opt, params = setup(case, mesh, params_dir)
    state = opt.init(params)
    leaves = [*_flat(params).values(), *_flat(state.mu).values(),
              *_flat(state.nu).values(), state.step]
    tree_bytes = sum(t.numel() * t.element_size() for t in leaves)
    counts, findings = check_train_step(step, params, state,
                                        batch(cfg, 0), cfg)
    return {"counts": counts, "findings": [str(f) for f in findings],
            "tree_bytes": tree_bytes}


def job_save(case: str, mesh, params_dir: str, ckpt: str) -> dict:
    from repro_torch.train import TrainLoop
    cfg, step, opt, params = setup(case, mesh, params_dir)
    losses = []

    def keep(p, o, b):
        out = step(p, o, b)
        losses.append(float(out[2]["loss"]))
        return out
    first = TrainLoop(keep, lambda i: batch(cfg, i), ckpt_dir=ckpt,
                      ckpt_every=2)
    params, state, _ = first.run(params, opt.init(params), 2,
                                 shardings=step.layout)
    rest = TrainLoop(keep, lambda i: batch(cfg, i))
    rest.run(params, state, 3, start_step=2, shardings=step.layout)
    return {"losses": losses}


def job_restore(case: str, mesh, params_dir: str, ckpt: str,
                rank: int) -> dict:
    import torch.distributed as dist
    from repro_torch.train import TrainLoop
    src = Path(ckpt) / "step_00000001"
    deadline = time.monotonic() + 90
    while not src.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {src}")
        time.sleep(0.2)
    mine = Path(ckpt + f"-restored-{mesh_name(mesh)}")
    if rank == 0:
        shutil.copytree(src, mine / src.name)
    dist.barrier()
    cfg, step, opt, params = setup(case, mesh, params_dir)
    losses = []

    def keep(p, o, b):
        out = step(p, o, b)
        losses.append(float(out[2]["loss"]))
        return out
    loop = TrainLoop(keep, lambda i: batch(cfg, i), ckpt_dir=str(mine),
                     ckpt_every=100)
    _, _, info = loop.run(params, opt.init(params), 3, shardings=step.layout)
    return {"losses": losses, "final_step": info["final_step"]}


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world,
                            timeout=datetime.timedelta(seconds=90))
    shape = tuple(int(v) for v in args.mesh.split("x"))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    results = {}
    out = Path(args.out)
    for job in args.jobs.split(","):
        kind, case = job.split(":")
        t0 = time.monotonic()
        try:
            if kind == "train":
                res = job_train(case, mesh, args.params)
            elif kind == "control":
                res = job_control(case, mesh, args.params)
            elif kind == "statcheck":
                res = job_statcheck(case, mesh, args.params)
            elif kind == "save":
                res = job_save(case, mesh, args.params, args.ckpt)
            elif kind == "restore":
                res = job_restore(case, mesh, args.params, args.ckpt,
                                  args.rank)
            else:
                raise ValueError(job)
        except Exception as e:           # reported, then the rank stops
            results[job] = {"error": f"{type(e).__name__}: {e}"}
            (out / f"rank{args.rank}.json").write_text(json.dumps(results))
            raise
        arrays = res.pop("arrays", None)
        if arrays is not None and args.rank == 0:
            np.savez(out / f"{kind}-{case}.npz", **arrays)
        res["seconds"] = time.monotonic() - t0
        results[job] = res
    (out / f"rank{args.rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())

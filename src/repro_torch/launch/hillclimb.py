"""Hill climb on the dry run: apply one named change to one cell, run it
again and append the (hypothesis, report) record to
``<out>/<arch>.<shape>.jsonl`` (port of ``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch command_r_plus_104b --shape train_4k --change remat_full \\
        --hypothesis "..."

Each entry of ``CHANGES`` maps a config to ``(cfg_override, rules,
mesh_override)`` for ``launch.dryrun.run_cell``; ``"baseline"`` is the
config as published. Every change moves the report of some cell. The
reference's changes whose knobs the port's code does not read are not
offered (they would give the baseline's numbers): ``grad_rs``, ``sp``,
``kv_seq_shard``, ``chunk_1024`` and ``chunk_2048``; ``cp`` becomes
``no_tp``, without the sequence split the port does not make. ROADMAP.md
names them with the reason (Queue A item 10f).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.dist.sharding import Rules
from repro_torch.launch.dryrun import fake_mesh, run_cell

__all__ = ["CHANGES", "apply_change", "main"]


def _mesh_16_2_8():
    """The port's counterpart of the reference's ``mesh_16_8_2``: 256
    cards as ``(data 16, model_b 2, model 8)``, so attention's tensor
    parallelism stays 8-way on ``model`` (one node's NVLink) while the
    FFN, vocab and experts split 16-way over ``(model_b, model)``, two
    nodes. The reference re-factors a TPU pod the same way to drop the
    head padding of 24- and 40-head archs."""
    return fake_mesh((16, 2, 8), ("data", "model_b", "model"))


CHANGES = {
    # the config as published (bf16 compute, FSDP x TP, remat per config)
    "baseline": lambda cfg: (cfg, Rules(), None),

    # the reference's context parallelism without its sequence split: no
    # head / mlp / vocab / expert tensor parallelism, the model axis
    # replicating the matmuls
    "no_tp": lambda cfg: (cfg.replace(tp=1, pad_heads=0, pad_kv_heads=0),
                          Rules.make({"heads": None, "mlp": None,
                                      "kv_heads": None, "vocab": None,
                                      "expert": None}),
                          None),

    # remat policy sweep (memory <-> recompute)
    "remat_dots": lambda cfg: (cfg.replace(remat="dots"), Rules(), None),
    "remat_full": lambda cfg: (cfg.replace(remat="full"), Rules(), None),
    "remat_none": lambda cfg: (cfg.replace(remat="none"), Rules(), None),

    # the SSD chunk (mamba2 / hymba: the quadratic block's size)
    "ssd_128": lambda cfg: (cfg.replace(ssd_chunk=128), Rules(), None),
    "ssd_512": lambda cfg: (cfg.replace(ssd_chunk=512), Rules(), None),

    # gradient accumulation (activation footprint vs gathers per micro)
    "accum_half": lambda cfg: (cfg.replace(
        grad_accum=max(1, cfg.grad_accum // 2)), Rules(), None),
    "accum_double": lambda cfg: (cfg.replace(
        grad_accum=cfg.grad_accum * 2), Rules(), None),

    # the re-factored mesh (see ``_mesh_16_2_8``): heads padded to 8
    "mesh_16_2_8": lambda cfg: (
        cfg.replace(tp=8),
        Rules.make({"heads": "model", "kv_heads": "model",
                    "mlp": ("model_b", "model"),
                    "vocab": ("model_b", "model"),
                    "expert": ("model_b", "model"),
                    "fsdp": ("data",), "batch": ("pod", "data")}),
        _mesh_16_2_8()),
}


def apply_change(arch_id, shape_name, change):
    cfg = get_config(arch_id)
    cfg2, rules, mesh = CHANGES[change](cfg)
    return run_cell(arch_id, shape_name, multi_pod=False, rules=rules,
                    cfg_override=cfg2, mesh_override=mesh, verbose=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--change", required=True, choices=sorted(CHANGES))
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--out", default="results/perf_torch")
    args = ap.parse_args(argv)

    rep = apply_change(args.arch, args.shape, args.change)
    rep["change"] = args.change
    rep["hypothesis"] = args.hypothesis
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}.{args.shape}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(rep, default=str) + "\n")
    print(f"[hillclimb] appended {args.change} -> {path}")


if __name__ == "__main__":
    main()

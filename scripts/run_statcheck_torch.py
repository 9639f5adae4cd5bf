#!/usr/bin/env python3
"""Static-contract gate over the port's serve stack (``repro_torch.statcheck``).

Runs the port's three statcheck layers and exits 1 on any finding,
printing each as ``[rule] program: message [offending op]``:

1. the AST host-path lint (stdlib-only: ``--lint-only`` imports no torch);
2. the op-log contracts per cache family, one decode step each: no Θ(pool)
   relayout, no host sync, the Eq. 3 fold on the Pairformer's plain path,
   the static-shape key bound, the decode kernels' launches (on the card)
   — plus the built-in negative control, a per-layer pool transpose that
   must trip the relayout rule (skip it with ``--skip-negative``);
3. with ``--mesh``, the mesh checks (``mesh_rules.check_backend_mesh``) of
   a sharded dense backend on a ``(2, 2)`` world of four ``gloo``
   processes, started here.

The contracts run on the card, as every entry point of the port does
(the kernels then run, and ``no-host-sync`` sees device-to-host copies
and the decode kernels' launches), and fail where there is none;
``--device cpu`` runs them on the CPU, where those two checks see
nothing::

    PYTHONPATH=src python scripts/run_statcheck_torch.py
    PYTHONPATH=src python scripts/run_statcheck_torch.py --device cpu
    PYTHONPATH=src python scripts/run_statcheck_torch.py --device cpu \
        --families dense,ring
    PYTHONPATH=src python scripts/run_statcheck_torch.py --device cpu \
        --pool-transpose                                  # must fail
    python scripts/run_statcheck_torch.py --lint-only
    PYTHONPATH=src python scripts/run_statcheck_torch.py --device cpu --mesh
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

DEFAULT_FAMILIES = "dense,moe,ring,ssm,pairformer"
MESH = (2, 2)


def run_lint() -> list:
    """``hostlint.lint_tree`` over the checkout. The module is loaded from
    its file: importing the ``repro_torch.statcheck`` package would import
    torch."""
    import importlib.util
    path = os.path.join(REPO, "src", "repro_torch", "statcheck",
                        "hostlint.py")
    spec = importlib.util.spec_from_file_location("hostlint", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses resolves it by name
    spec.loader.exec_module(mod)
    return mod.lint_tree(REPO)


def run_contract_checks(families, device, self_test: bool,
                        pool_transpose: bool = False) -> list:
    import contextlib

    from repro_torch.statcheck.contracts import legacy_adapter, run_contracts
    ctx = legacy_adapter() if pool_transpose else contextlib.nullcontext()
    with ctx:
        return run_contracts(families, device=device,
                             self_test=self_test and not pool_transpose)


def mesh_rank(init_method: str, out: str) -> None:
    """One rank of the ``(2, 2)`` world: a sharded, paged dense backend's
    mesh checks; rank 0 writes the findings to ``out``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model, init_params
    from repro_torch.serve.backend import TokenDecodeBackend
    from repro_torch.statcheck import check_backend_mesh
    from repro_torch.statcheck.contracts import fill

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    cfg = smoke_config("stablelm_12b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    be = TokenDecodeBackend(get_model(cfg), params, max_len=32, n_slots=4,
                            page_size=4, mesh=mesh, device="cpu")
    fill(be)
    findings = check_backend_mesh(be, program="dense/decode@(2,2)",
                                  expect_all=("all_reduce",))
    if rank == 0:
        with open(out, "w") as f:
            json.dump([str(x) for x in findings], f)
    dist.destroy_process_group()


def run_mesh_checks() -> list:
    """Start the four ranks and return rank 0's findings (as strings)."""
    world = MESH[0] * MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "findings.json")
        env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.join(REPO, "src"))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             f"file://{tmp}/store", "--mesh-out", out],
            env=dict(env, RANK=str(r))) for r in range(world)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            return [f"[mesh] the (2, 2) world's ranks exited with {codes}"]
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=DEFAULT_FAMILIES,
                    help=f"comma-separated (default {DEFAULT_FAMILIES})")
    ap.add_argument("--device", default=None,
                    help="where the contracts run (default: the card, an "
                    "error where there is none; 'cpu' runs them on the "
                    "CPU)")
    ap.add_argument("--lint-only", action="store_true",
                    help="AST host-path lint only (no torch import)")
    ap.add_argument("--no-lint", action="store_true")
    ap.add_argument("--skip-negative", action="store_true",
                    help="skip the built-in pool-transpose tripwire")
    ap.add_argument("--pool-transpose", action="store_true",
                    help="wrap the decode op in a per-layer pool transpose "
                    "(the legacy layout's adapter): the run must fail")
    ap.add_argument("--mesh", action="store_true",
                    help="also run the mesh checks on a (2, 2) gloo world")
    ap.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_rank is not None:
        mesh_rank(args.mesh_rank, args.mesh_out)
        return 0

    findings = []
    if not args.lint_only:
        from repro_torch.serve.backend import resolve_device
        device = resolve_device(args.device)
    if not args.no_lint:
        findings += run_lint()
    if not args.lint_only:
        families = [f for f in args.families.split(",") if f]
        findings += run_contract_checks(families, device,
                                        not args.skip_negative,
                                        args.pool_transpose)
        if args.mesh:
            findings += run_mesh_checks()

    for f in findings:
        print(f, file=sys.stderr)
    if findings:
        print(f"statcheck: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    scope = ("lint" if args.lint_only else
             f"contracts[{args.families}; {device}]" if args.no_lint
             else f"lint+contracts[{args.families}; {device}]")
    print(f"statcheck passed ({scope}{'+mesh' if args.mesh else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit), and the same checks as the last
lines of standard error. Exits non-zero with no result where the cell's
CUDA devices are missing, or where JAX or the JAX package got loaded.

``--control 1`` runs the cell's control instead (the plain reference in
float8 in the program's place, no window) and prints its checks, which
must come out not correct; ``--fault NAME`` plants a fault of the cell's
family file (``portbench/families/<family>.py``) in the program, which
must too.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Import paths, and every cache of the program inside the checkout
    at a fixed path (the kernels themselves build under ``build/kernels``
    of the checkout)."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p not in (here, "")]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of the cell's family file in "
                         "the program (its check must come out not "
                         "correct)")
    args = ap.parse_args(argv)
    _environment()
    from portbench import harness
    try:
        ctx = harness.context(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    except harness.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if args.control:
        checks = harness.control(ctx)
        out = {"control": True, "correct": all(
            c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}
    else:
        out = harness.run(ctx, T_START, args.fault)
        checks = out["checks"]
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

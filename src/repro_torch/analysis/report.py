"""Turn a directory of the port's dry-run reports (one JSON per cell,
``launch/dryrun.py``) into its three tables (port of
``repro.analysis.report``): the roofline of the single-pod cells, the
multi-pod memory proof and the collective breakdown. Every figure is the
analytic H100 SXM roofline at data-sheet rates, not a measurement.

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch
"""
from __future__ import annotations

import json
import os
import sys

__all__ = ["load", "roofline_table", "multipod_table",
           "collective_breakdown", "main"]


def load(d):
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


def roofline_table(reports):
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "useful ratio | roofline frac | mem(plain) | peak/rank |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(reports, key=lambda r: (r["arch_id"], r["shape"])):
        if r["mesh"] != "single" or "compute_s" not in r:
            continue
        mem = (r.get("memory") or {}).get("peak_bytes")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction'] * 100:.1f}% | "
            f"{fmt_s(r.get('memory_s_xla'))} | {fmt_b(mem)} |")
    return "\n".join(rows)


def multipod_table(reports, mesh="multi", label="2x32x8"):
    """Per-rank peak memory of the ``mesh`` cells (``"multi"``; ``"node"``
    for one node's ``(1, 8)``) against the card's 80 GB."""
    rows = ["| arch | shape | mesh | dry run | peak mem/rank | fits 80 GB |",
            "|---|---|---|---|---|---|"]
    for r in sorted(reports, key=lambda r: (r["arch_id"], r["shape"],
                                            r["mesh"])):
        if r["mesh"] != mesh:
            continue
        mem = (r.get("memory") or {}).get("peak_bytes")
        fits = "-" if mem is None else ("yes" if mem <= r.get(
            "hbm_bytes", 80e9) else "no")
        rows.append(f"| {r['arch']} | {r['shape']} | {label} | "
                    f"{r['run_s']:.1f}s | {fmt_b(mem)} | {fits} |")
    return "\n".join(rows)


def collective_breakdown(reports, top=6):
    rows = ["| arch | shape | all-gather | all-reduce | reduce-scatter | "
            "all-to-all | permute |", "|---|---|---|---|---|---|---|"]
    sel = [r for r in reports if r["mesh"] == "single"
           and "collective_detail" in r]
    sel.sort(key=lambda r: -r.get("collective_s", 0))
    for r in sel[:top]:
        d = r["collective_detail"]
        rows.append(f"| {r['arch']} | {r['shape']} | {fmt_b(d['all-gather'])} "
                    f"| {fmt_b(d['all-reduce'])} | {fmt_b(d['reduce-scatter'])} "
                    f"| {fmt_b(d['all-to-all'])} | "
                    f"{fmt_b(d['collective-permute'])} |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "results/dryrun_torch"
    reports = load(d)
    print("## Roofline (single pod, (32, 8) = 256 H100s; analytic, "
          "data-sheet rates)\n")
    print(roofline_table(reports))
    print("\n## Multi-pod memory proof ((2, 32, 8) = 512 H100s)\n")
    print(multipod_table(reports))
    if any(r["mesh"] == "node" for r in reports):
        print("\n## One node ((1, 8) = 8 H100s)\n")
        print(multipod_table(reports, "node", "1x8"))
    print("\n## Collective breakdown (most collective-bound cells)\n")
    print(collective_breakdown(reports))


if __name__ == "__main__":
    main()

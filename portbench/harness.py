"""One run of one cell: set-up, the measured window (traced or not), the
check of what the window produced against the plain reference, and the
result line.

Everything of a cell is found by name: the cell's entry in
``BENCHMARK.json``, its configuration ``configs/<config>.json`` (whose
``family`` names the file in ``families/`` that reaches the program and
plants its faults, and whose ``reference`` names the plain reference in
``reference/``), its traffic ``traffic/<traffic>.json`` (whose ``driver``
names the module in ``drivers/`` that runs it), its limits
``limits/<cell>.json``, and each of its metrics ``metrics/<metric>.py``.
Adding a model family, a configuration, a cell, a mix or a metric adds
files and edits none but ``BENCHMARK.json``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from portbench import inputs, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The cell's cards are not there: no result may be printed."""


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(b: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    untraced (an entry without ``workloads`` in every cell), its per-layer
    ones, each of which lists its cells, traced."""
    if not trace:
        return [m for m in b["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in b["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the seed, the device, and the
    program's config and weight layout."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: object
    spec: dict
    traffic: dict
    limits: dict
    cfg: object = None
    layout: list = None

    def seed_for(self, *parts) -> int:
        return inputs.stream_seed(self.seed, *parts)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.spec['reference']}")

    def family(self):
        from portbench import port
        return port.family(self.spec)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    units: list
    window: tuple
    setup_s: float
    peak_bytes: int
    trace: object = None


def _card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits",
                            f"--id={device.index or 0}"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return out


def context(cell: str, seed: int, seconds: float, trace: bool, *,
            device=None, smoke: bool = False, traffic_overrides: dict = None,
            config_overrides: dict = None) -> Context:
    """The cell's context. ``device`` None means the cards the cell asks
    for, and raises ``NoDevice`` where they are not; a CPU device,
    ``smoke`` (the program's reduced config) and the overrides are for
    tests at sizes a CPU holds."""
    import torch
    from portbench import port
    b = bench()
    w = workload(b, cell)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < w["chips"]:
            raise NoDevice(f"{cell} needs {w['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    spec = load_json("configs", f"{w['config']}.json")
    traffic = dict(load_json("traffic", f"{w['traffic']}.json"),
                   **(traffic_overrides or {}))
    cfg = port.config(spec, smoke).replace(**(config_overrides or {}))
    spec = port.widths(spec, cfg)
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device(device), spec=spec, traffic=traffic,
                   limits=load_json("limits", f"{cell}.json"), cfg=cfg,
                   layout=port.layout(cfg))


def checks_of(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of every number compared."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of the limited numbers {missing}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def driver_of(ctx: Context):
    return importlib.import_module(
        f"portbench.drivers.{ctx.traffic['driver']}")


def run(ctx: Context, t_start: float, fault: str = None) -> dict:
    """Set-up, window, check; returns the result object. ``fault`` plants
    one of the cell's family's ``FAULTS`` in the program (to show the check
    fails it)."""
    import torch
    from portbench import faults
    driver = driver_of(ctx)
    cuda = ctx.device.type == "cuda"
    tracer = tracing.Tracer(ctx.trace, cuda)
    with faults.plant(ctx.family(), fault):
        state = driver.setup(ctx)
        ctx.sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(ctx.device)
        setup_s = time.perf_counter() - t_start
        with tracer.window():
            record = driver.window(ctx, state)
        ctx.sync()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    kept = driver.release(ctx, state, record)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check(ctx, record, kept)
    checks = checks_of(numbers, ctx.limits)
    b = bench()
    r = Run(units=record["units"], window=record["window"],
            setup_s=setup_s, peak_bytes=peak, trace=tracer.trace)
    metrics = {}
    for m in cell_metrics(b, ctx.cell, ctx.trace):
        value = metric_reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(_card(ctx.device), memory_peak_bytes=peak)
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device}
    if tracer.trace is not None:
        t = tracer.trace
        device.update(busy_s=t.busy_s(), window_s=t.window_s())
        spans = collections.Counter(n for n, *_ in t.cpu
                                    if n.startswith(tracing.PROGRAM))
        print(f"trace: {len(t.cpu)} host events, {len(t.device)} device "
              f"ops ({sum(op[3] is not None for op in t.device)} with their "
              f"launch), program spans {dict(sorted(spans.items()))}",
              file=sys.stderr)
        out["breakdown"] = {"device_ops": t.device_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["checks"] = checks
    return out


def control(ctx: Context) -> dict:
    """The control: the reference in float8 put in the program's place,
    read as a run reads the program (no window). Returns the checks."""
    return checks_of(driver_of(ctx).control(ctx), ctx.limits)

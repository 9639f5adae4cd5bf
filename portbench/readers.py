"""The arithmetic the metric files share. A metric file names its layer,
unit and the end-to-end metric it moves, and reads one of these; ``None``
means there is nothing to read in this run (the harness then leaves the
metric out of the result)."""
from __future__ import annotations

import bisect

from portbench import tracing, yardstick


def rate(run) -> float:
    """Tokens (or mesh points) of every unit completed in the window, over
    the time from the window's start to the last unit's end."""
    t0, t1 = run.window
    return sum(u["tokens"] for u in run.units) / (t1 - t0)


def p95_ms(run):
    lat = [u["latency"] for u in run.units if "latency" in u]
    return 1e3 * yardstick.p95(lat) if lat else None


def _durations(ops) -> float:
    return sum(e - s for _, s, e, _, _ in ops)


def attn_roofline(run):
    """Sum of the attention calls' bounds over the device time of what
    was launched under their spans, in percent. Each call's bound is its
    unit's per-call work."""
    t = run.trace
    if t is None:
        return None
    calls = t.ranges(tracing.ATTENTION)
    spent = _durations(t.launched_in(calls))
    if not calls or spent <= 0:
        return None
    units = sorted((s, e) for s, e, tid in t.ranges(tracing.UNIT)
                   if tid == t.main_tid)
    if len(units) != len(run.units):
        raise AssertionError(f"{len(units)} unit spans for "
                             f"{len(run.units)} units")
    starts = [s for s, _ in units]
    bound = 0.0
    for s, _, _ in calls:
        i = bisect.bisect_right(starts, s) - 1
        work = run.units[i]["attn"]
        bound += yardstick.bound_seconds(work["flops"], work["bytes"])
    return 100.0 * bound / spent


def backward_share(run):
    """Device time launched inside the autograd engine's node ranges (the
    backward, its recomputation included) over the device's busy time, in
    percent."""
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    ops = t.launched_in(t.ranges(tracing.BACKWARD))
    return 100.0 * _durations(ops) / t.busy_s() if ops else None


def mfu(run):
    """Model FLOPs of the traced window's units over its length and the
    card's bf16 peak, in percent."""
    t = run.trace
    if t is None or not any(u["model_flops"] for u in run.units):
        return None
    flops = sum(u["model_flops"] for u in run.units)
    return 100.0 * flops / t.window_s() / yardstick.PEAK_BF16_FLOPS


def idle_share(run):
    """The share of the traced window in which no device operation ran,
    in percent."""
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())

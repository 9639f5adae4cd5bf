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


def device_seconds(ops) -> float:
    """Summed durations of device operations (``Trace.device`` entries)."""
    return sum(e - s for _, s, e, _, _ in ops)


def call_works(run, span: str, reverse: bool = False) -> list:
    """``[(start, end, tid, work)]``: each call of the program's span
    ``span`` in the traced window, with its work. A call belongs to the
    unit whose ``portbench.unit`` range (on the main thread) holds its
    start. A unit's ``attn`` is one work, every call's, or a list of works,
    one per call in the order the calls start; ``reverse`` pairs the list
    the other way round (a backward meets the calls in the reverse of the
    forward's order). Raises where the unit ranges are not one a unit, a
    call lies before the first unit, or a unit's list and its calls differ
    in number."""
    t = run.trace
    units = sorted((s, e) for s, e, tid in t.ranges(tracing.UNIT)
                   if tid == t.main_tid)
    if len(units) != len(run.units):
        raise AssertionError(f"{len(units)} unit spans for "
                             f"{len(run.units)} units")
    starts = [s for s, _ in units]
    calls = [[] for _ in units]
    for call in sorted(t.ranges(span)):
        i = bisect.bisect_right(starts, call[0]) - 1
        if i < 0:
            raise AssertionError(f"a {span} call at {call[0]} before the "
                                 "first unit")
        calls[i].append(call)
    out = []
    for i, (unit, held) in enumerate(zip(run.units, calls)):
        works = unit["attn"]
        if isinstance(works, list):
            if len(works) != len(held):
                raise AssertionError(f"unit {i}: {len(held)} calls of "
                                     f"{span} for {len(works)} works")
            works = works[::-1] if reverse else works
        else:
            works = [works] * len(held)
        out += [(*call, w) for call, w in zip(held, works)]
    return out


def attn_roofline(run, span: str, factor: float = 1, reverse: bool = False):
    """Sum of the attention calls' bounds over the device time of what
    was launched under their spans (the program's ``span``), in percent.
    Each call's bound is ``factor`` times its work (``call_works``) in
    FLOPs and in bytes."""
    t = run.trace
    if t is None:
        return None
    calls = t.ranges(span)
    spent = device_seconds(t.launched_in(calls))
    if not calls or spent <= 0:
        return None
    bound = sum(yardstick.bound_seconds(factor * w["flops"],
                                        factor * w["bytes"])
                for *_, w in call_works(run, span, reverse))
    return 100.0 * bound / spent


def backward_share(run):
    """Device time launched inside the autograd engine's node ranges (the
    backward, its recomputation included) over the device's busy time, in
    percent."""
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    ops = t.launched_in(t.ranges(tracing.BACKWARD))
    return 100.0 * device_seconds(ops) / t.busy_s() if ops else None


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

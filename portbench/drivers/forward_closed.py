"""Closed-loop inference of a model that is not served (the PDE solver):
each client sends its next request when its last result is on the host.

A request is one input from a pool made from the seed at set-up, in an
order drawn from the seed; its result is copied to the host, which ends
its latency. The check compares every request's output with the plain
reference's output for its input, each field's gap over the field's reach
(``sqrt(d_model)`` times the norm of its column of the output head: the
largest value a unit-RMS final state can give it). With random weights
the outputs' own size swings from seed to seed with the head's alignment
to the final state, and a gap relative to it swings with it.
"""
from __future__ import annotations

import time

import torch

from portbench import inputs, tracing, weights, yardstick
from portbench.reference.arith import Arith, exact_float32

def faults(ctx) -> tuple:
    """The faults of the cell's family file this driver's cells can have."""
    return ("answer_altered",)


def _pool(ctx) -> list:
    t, s = ctx.traffic, ctx.spec
    return [inputs.mesh_points(ctx.seed, i, t["batch"], t["points"],
                               s["coord_dim"], ctx.device)
            for i in range(t["pool"])]


def setup(ctx) -> dict:
    t, s = ctx.traffic, ctx.spec
    if t["clients"] != 1:
        raise ValueError("forward_closed drives one client")
    params = weights.make(ctx.layout, ctx.seed_for("weights"), ctx.device,
                          torch.float32)
    fwd = ctx.family().forward(ctx.cfg)
    pool = _pool(ctx)
    for x in pool[:2]:
        fwd(params, x).cpu()
    attn = yardstick.attention_work(s, t["batch"], t["points"])
    tokens = t["batch"] * t["points"]
    unit = {"tokens": tokens, "attn": attn,
            "model_flops": yardstick.model_flops(
                s, tokens, attn["flops"] * s["n_layers"], False)}
    return {"params": params, "fwd": fwd, "pool": pool, "unit": unit,
            "order": inputs.order(ctx.seed, t["pool"], "requests")}


def window(ctx, st: dict) -> dict:
    params, fwd, pool, order = st["params"], st["fwd"], st["pool"], \
        st["order"]
    units, outputs = [], []
    t0 = time.perf_counter()
    while True:
        i = int(order[len(units) % len(order)])
        with tracing.range_(tracing.UNIT):
            ts = time.perf_counter()
            out = fwd(params, pool[i]).cpu()
            te = time.perf_counter()
        units.append(dict(st["unit"], t0=ts, t1=te, latency=te - ts))
        outputs.append((i, out))
        if te - t0 >= ctx.seconds:
            break
    return {"units": units, "window": (t0, te), "attempted": len(units),
            "outputs": outputs}


def release(ctx, st: dict, record: dict) -> dict:
    record["failed"] = sum(not bool(torch.isfinite(o.float()).all())
                           for _, o in record["outputs"])
    kept = {"pool": st["pool"]}
    st.clear()
    return kept


def _reference(ctx, pool: list, used, lowp: bool) -> tuple:
    """The reference's outputs by pool index, and each output field's
    reach."""
    ref = ctx.reference()
    with exact_float32(), torch.no_grad():
        p = weights.make(ctx.layout, ctx.seed_for("weights"), ctx.device,
                         torch.float32)
        reach = (ctx.spec["d_model"] ** 0.5 * p["out_head"].norm(dim=0)).cpu()
        return {i: ref.forward(p, pool[i], ctx.spec, Arith(lowp)).cpu()
                for i in sorted(used)}, reach


def compare(outputs: list, want: dict, reach) -> dict:
    """The worst request's RMS gap and largest gap, each field's over its
    reach."""
    rms = peak = 0.0
    for i, out in outputs:
        gap = (out.float() - want[i]) / reach
        rms = max(rms, float(gap.square().mean().sqrt()))
        peak = max(peak, float(gap.abs().max()))
    return {"out_rms_gap": rms, "out_max_gap": peak}


def check(ctx, record: dict, kept: dict) -> dict:
    outputs = record.pop("outputs")
    want, reach = _reference(ctx, kept["pool"], {i for i, _ in outputs},
                             False)
    return compare(outputs, want, reach)


def control(ctx) -> dict:
    pool = _pool(ctx)
    used = range(len(pool))
    low, _ = _reference(ctx, pool, used, True)
    want, reach = _reference(ctx, pool, used, False)
    return compare(list(low.items()), want, reach)

"""Closed-loop inference of the Pairformer trunk: one client; a request is
one complex's residue features ``(1, N, 64)`` from a pool made from the
seed, sent in an order drawn from the seed. The check compares every
request's coordinates with the plain reference's: the largest gap over
the reference's largest magnitude."""
from __future__ import annotations

import time

import torch

from portbench import inputs, tracing, weights, yardstick


def faults(ctx) -> tuple:
    return ("answer_altered",)


def _params(ctx) -> dict:
    return {"trunk": weights.make(ctx.layout, ctx.seed_for("weights"),
                                  ctx.device, torch.float32),
            "factors": weights.make(ctx.family().factor_layout(ctx.cfg),
                                    ctx.seed_for("factors"), ctx.device,
                                    torch.float32)}


def _pool(ctx) -> list:
    n = ctx.traffic["residues"]
    return [torch.randn((1, n, 64), device=ctx.device,
                        generator=inputs.generator(ctx.seed, ctx.device,
                                                   "feats", i))
            for i in range(ctx.traffic["pool"])]


def work(ctx) -> list:
    """One attention call a block, in call order: H heads of width
    ``d_model / H`` over N residues, rank-R float32 factors per head."""
    s, n = ctx.spec, ctx.traffic["residues"]
    h, r = s["n_heads"], s["bias_rank"]
    call = yardstick.attention_call(
        batch=1, heads=h, nq=n, nk=n, head_dim=s["d_model"] // h, rank=r,
        causal=False, factor_bytes=4 * 2 * n * h * r)
    return [call] * s["n_layers"]


def setup(ctx) -> dict:
    if ctx.traffic["clients"] != 1:
        raise ValueError("pair_closed drives one client")
    params, pool = _params(ctx), _pool(ctx)
    fwd = ctx.family().forward(ctx.cfg)
    fwd(params, pool[0]).cpu()
    attn, n = work(ctx), ctx.traffic["residues"]
    unit = {"tokens": n, "attn": attn,
            "model_flops": yardstick.model_flops(
                ctx.spec, n, sum(w["flops"] for w in attn), False)}
    return {"params": params, "fwd": fwd, "pool": pool, "unit": unit,
            "order": inputs.order(ctx.seed, len(pool), "requests")}


def window(ctx, st: dict) -> dict:
    units, outputs = [], []
    t0 = time.perf_counter()
    while True:
        i = int(st["order"][len(units) % len(st["order"])])
        with tracing.range_(tracing.UNIT):
            ts = time.perf_counter()
            out = st["fwd"](st["params"], st["pool"][i]).cpu()
            te = time.perf_counter()
        units.append(dict(st["unit"], t0=ts, t1=te, latency=te - ts))
        outputs.append((i, out))
        if te - t0 >= ctx.seconds:
            break
    return {"units": units, "window": (t0, te), "attempted": len(units),
            "outputs": outputs}


def release(ctx, st: dict, record: dict) -> dict:
    record["failed"] = sum(not bool(torch.isfinite(o).all())
                           for _, o in record["outputs"])
    kept = {"pool": st["pool"]}
    st.clear()
    return kept


def _reference(ctx, pool, used, dtype) -> dict:
    p = _params(ctx)
    with torch.no_grad():
        return {i: ctx.reference().forward(p["trunk"], p["factors"],
                                           pool[i], ctx.spec, dtype)
                .float().cpu() for i in sorted(used)}


def _gap(outputs, want) -> dict:
    return {"out_max_gap": max(float((o.float() - want[i]).abs().max()
                                     / want[i].abs().max())
                               for i, o in outputs)}


def check(ctx, record: dict, kept: dict) -> dict:
    outputs = record.pop("outputs")
    return _gap(outputs, _reference(ctx, kept["pool"],
                                    {i for i, _ in outputs}, torch.float32))


def control(ctx) -> dict:
    pool = _pool(ctx)
    used = range(len(pool))
    low = _reference(ctx, pool, used, torch.bfloat16)
    return _gap(list(low.items()), _reference(ctx, pool, used,
                                              torch.float32))

"""Training cells: the program's train step (``train.make_train_step`` over
the model's ``loss``, with the program's AdamW) on batches made from the
seed, one new batch a step.

Set-up builds the one step object with its weights and optimizer state and
drives it through the first ``check_steps`` steps, which also warm every
shape; the window goes on with the same object from there. The check
follows those first steps with the plain reference: each step's loss, each
leaf's gradient at step 1 (read back from the program's first moment, and
kept on the host), and each leaf's change after the last checked step
(read before the window's first step overwrites it).
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from portbench import inputs, port, tracing, weights, yardstick
from portbench.reference.adamw import AdamW as RefAdamW
from portbench.reference.arith import Arith, exact_float32

def faults(ctx) -> tuple:
    """The faults of the cell's family file this driver's cells can have
    (a batch of one mesh loses half of its points)."""
    return ("state_unchanged", "half_batch")


def batch(ctx, step: int) -> dict:
    t, s = ctx.traffic, ctx.spec
    if t["inputs"] == "mesh":
        return inputs.mesh_batch(ctx.seed, step, t["batch"], t["points"],
                                 s["coord_dim"], s["out_channels"],
                                 ctx.device)
    raise ValueError(f"unknown training inputs {t['inputs']!r}")


def work(ctx) -> dict:
    """Mesh points, model FLOPs and per-call attention work of one step."""
    t, s = ctx.traffic, ctx.spec
    n = t["points"]
    micro = t["batch"] // t["grad_accum"]
    attn = yardstick.attention_work(s, micro, n)
    tokens = t["batch"] * n
    total = attn["flops"] * s["n_layers"] * t["grad_accum"]
    return {"tokens": tokens, "attn": attn,
            "model_flops": yardstick.model_flops(s, tokens, total, True)}


def _first_moment_grads(opt_state, layout, scale: float, b1: float) -> dict:
    """Each leaf's gradient as the optimizer got it at step 1, on the host:
    its first moment is ``(1 - b1) * scale * g``."""
    mu = opt_state.mu
    return {path: weights.get(mu, path).detach().float().cpu()
            / ((1 - b1) * scale) for path, *_ in layout}


def _change_norms(params: dict, layout, seed: int, device) -> dict:
    """``||p - p0||`` of each leaf, ``p0`` made again from the seed."""
    return {path: float((weights.get(params, path).detach() - p0).norm())
            for path, p0 in weights.leaves(layout, seed, device,
                                           torch.float32)}


def setup(ctx) -> dict:
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import make_train_step
    o = ctx.traffic["optimizer"]
    seed_w = ctx.seed_for("weights")
    params = weights.make(ctx.layout, seed_w, ctx.device, torch.float32)
    opt = AdamW(lr_fn=constant(o["lr"]), b1=o["b1"], b2=o["b2"],
                eps=o["eps"], weight_decay=o["weight_decay"],
                clip_norm=o["clip_norm"])
    step = make_train_step(port.model(ctx.cfg).loss, opt,
                           grad_accum=ctx.traffic["grad_accum"])
    state = opt.init(params)
    readings = {"loss": []}
    for k in range(ctx.traffic["check_steps"]):
        params, state, m = step(params, state, batch(ctx, k))
        readings["loss"].append(float(m["loss"]))
        if k == 0:
            scale = min(1.0, o["clip_norm"] / max(float(m["grad_norm"]),
                                                   1e-9))
            readings["grad"] = _first_moment_grads(state, ctx.layout, scale,
                                                   o["b1"])
    readings["update"] = _change_norms(params, ctx.layout, seed_w,
                                       ctx.device)
    return {"step": step, "params": params, "opt": state,
            "readings": readings, "work": work(ctx)}


def window(ctx, st: dict) -> dict:
    step, params, opt, w = st["step"], st["params"], st["opt"], st["work"]
    k = ctx.traffic["check_steps"]
    units, losses = [], []
    t0 = time.perf_counter()
    while True:
        with tracing.range_(tracing.UNIT):
            ts = time.perf_counter()
            params, opt, m = step(params, opt, batch(ctx, k))
            ctx.sync()
            te = time.perf_counter()
        units.append(dict(w, t0=ts, t1=te))
        losses.append(m["loss"])
        k += 1
        if te - t0 >= ctx.seconds:
            break
    st["params"], st["opt"] = params, opt
    return {"units": units, "window": (t0, te), "attempted": len(units),
            "losses": losses}


def release(ctx, st: dict, record: dict) -> dict:
    losses = torch.stack(record.pop("losses"))
    record["failed"] = int((~torch.isfinite(losses)).sum())
    readings = st["readings"]
    st.clear()
    return {"readings": readings}


def _ref_readings(ctx, lowp: bool) -> dict:
    """The reference's readings of the first ``check_steps`` steps, in
    float32 (or the control's float8)."""
    ref, a = ctx.reference(), Arith(lowp)
    t, o = ctx.traffic, ctx.traffic["optimizer"]
    seed_w = ctx.seed_for("weights")
    with exact_float32():
        p = {path: x.requires_grad_(True) for path, x in weights.leaves(
            ctx.layout, seed_w, ctx.device, torch.float32)}
        tree = weights.nest(p.items())
        opt = RefAdamW(o["lr"], o["b1"], o["b2"], o["eps"],
                       o["weight_decay"], o["clip_norm"])
        out = {"loss": []}
        for k in range(t["check_steps"]):
            loss = ref.loss(tree, batch(ctx, k), ctx.spec, a)
            loss.backward()
            out["loss"].append(float(loss.detach()))
            grads = [x.grad for x in p.values()]
            if k == 0:
                out["grad"] = {path: g.detach().cpu()
                               for path, g in zip(p, grads)}
            opt.step(list(p.values()), grads)
            for x in p.values():
                x.grad = None
        del opt
        p0 = dict(weights.flatten(weights.make(ctx.layout, seed_w,
                                               ctx.device, torch.float32)))
        out["update"] = {path: float((x.detach() - p0[path]).norm())
                         for path, x in p.items()}
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The gaps by the worst leaf: between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; ``grad_diff`` takes the norm of the step-1
    gradients' difference instead, which sees a gradient of the right size
    that points elsewhere. The change leaves out leaves whose reference
    gradient is under a thousandth of the median leaf's (they move by
    round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                  ref["loss"]))
    g = {k: float(x.norm()) for k, x in ref["grad"].items()}
    pg = {k: float(x.norm()) for k, x in prog["grad"].items()}
    gmed = statistics.median(g.values())
    grad = max(abs(pg[k] - g[k]) / max(g[k], gmed) for k in g)
    diff = {k: float((prog["grad"][k] - ref["grad"][k]).norm())
            / max(g[k], gmed) for k in g}
    whole = sum(float((prog["grad"][k] - ref["grad"][k]).square().sum())
                for k in g) ** 0.5 / sum(x * x for x in g.values()) ** 0.5
    moving = [k for k in g if g[k] >= 1e-3 * gmed]
    u = ref["update"]
    umed = statistics.median(u[k] for k in moving)
    update = max(abs(prog["update"][k] - u[k]) / max(u[k], umed)
                 for k in moving)
    print("readings: loss " + " ".join(
        f"{a!r}/{b!r}" for a, b in zip(prog["loss"], ref["loss"]))
        + "; grad " + "; ".join(
            f"{'.'.join(k)} {pg[k]:.6g}/{g[k]:.6g} diff {diff[k]:.6g}"
            for k in g) + f"; whole diff {whole!r}"
        + "; update " + "; ".join(
            f"{'.'.join(k)} {prog['update'][k]:.6g}/{u[k]:.6g}" for k in u)
        + f"; left out of the change: {sorted(set(g) - set(moving))}",
        file=sys.stderr)
    return {"loss_gap": loss, "grad_gap": grad,
            "grad_diff": max(diff.values()), "update_gap": update}


def check(ctx, record: dict, kept: dict) -> dict:
    return compare(kept["readings"], _ref_readings(ctx, lowp=False))


def control(ctx) -> dict:
    return compare(_ref_readings(ctx, lowp=True),
                   _ref_readings(ctx, lowp=False))

"""attn_bwd_roofline.train: The attention backward's share of its roofline in
the training step: the sum of the calls' bounds over the device time launched
inside the program's ``repro_torch.attn.bwd`` spans, in percent. A program
without the span reads nothing.

Each call's bound is ``yardstick.bound_seconds`` of twice the forward's
count of its unit (the unit whose ``portbench.unit`` range holds the span's
start):

- FLOPs: the backward's two products for the forward's one, the convention
  of ``yardstick.model_flops``; recomputation is not counted;
- bytes: q, k, v, o and dO read and dq, dk, dv written (eight tensors
  against the forward's four), the factors read and their gradients
  written.

The count does not depend on what computes the backward: a recompute, a
backward kernel or a library's are held to the same bound."""
import bisect

from portbench import readers, tracing, yardstick

SPAN = "repro_torch.attn.bwd"
LAYER = "Training step: ops._FlashAttention.backward (repro_torch.attn.bwd)"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = t.ranges(SPAN)
    spent = readers._durations(t.launched_in(calls))
    if not calls or spent <= 0:
        return None
    starts = sorted(s for s, _, tid in t.ranges(tracing.UNIT)
                    if tid == t.main_tid)
    if len(starts) != len(run.units):
        raise AssertionError(f"{len(starts)} unit spans for "
                             f"{len(run.units)} units")
    bound = 0.0
    for s, _, _ in calls:
        work = run.units[bisect.bisect_right(starts, s) - 1]["attn"]
        bound += yardstick.bound_seconds(2 * work["flops"],
                                         2 * work["bytes"])
    return 100.0 * bound / spent

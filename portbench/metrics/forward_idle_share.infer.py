"""forward_idle_share.infer: The share of the traced window in which the
device was idle while the host ran the program's forward: idle time (the
window less the device's busy time) that overlaps the program's
``repro_torch.pde.forward`` spans on the main thread, over the window, in
percent. What is left of ``idle_share.infer`` lies in the harness (the
result's copy, the loop between requests). A program without the span reads
nothing."""
from portbench import yardstick

SPAN = "repro_torch.pde.forward"
LAYER = "Model step: models/pde.py (host)"
UNIT = "%"
MOVES = "infer_tokens_per_s"
BETTER = "lower"


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    spans = yardstick.union((s, e) for s, e, tid in t.ranges(SPAN)
                            if tid == t.main_tid)
    if not spans:
        return None
    idle = _overlap(spans, [t.window]) - _overlap(spans, t.busy())
    return 100.0 * idle / t.window_s()

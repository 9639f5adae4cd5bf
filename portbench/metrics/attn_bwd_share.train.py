"""attn_bwd_share.train: The attention backward's share of the device's busy
time in the training step: the device time launched inside the program's
``repro_torch.attn.bwd`` spans (the whole of ``ops._FlashAttention.backward``,
whatever computes it), each on its own thread (the autograd engine's), over
the busy time. It caps what a faster attention backward can gain end to end.
A program without the span reads nothing."""
from portbench import readers

SPAN = "repro_torch.attn.bwd"
LAYER = "Training step: ops._FlashAttention.backward (repro_torch.attn.bwd)"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "lower"


def read(run):
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    ops = t.launched_in(t.ranges(SPAN))
    return 100.0 * readers.device_seconds(ops) / t.busy_s() if ops else None

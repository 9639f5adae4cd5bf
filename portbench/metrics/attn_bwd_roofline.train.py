"""attn_bwd_roofline.train: The attention backward's share of its roofline in
the training step: the sum of the calls' bounds over the device time launched
inside the program's ``repro_torch.attn.bwd`` spans, in percent. A program
without the span reads nothing.

Each call's bound is ``yardstick.bound_seconds`` of twice the forward's
count of its call (``readers.call_works``; a list of works is met in
reverse, as the backward visits the calls):

- FLOPs: the backward's two products for the forward's one, the convention
  of ``yardstick.model_flops``; recomputation is not counted;
- bytes: q, k, v, o and dO read and dq, dk, dv written (eight tensors
  against the forward's four), the factors read and their gradients
  written.

The count does not depend on what computes the backward: a recompute, a
backward kernel or a library's are held to the same bound."""
from portbench import readers

SPAN = "repro_torch.attn.bwd"
LAYER = "Training step: ops._FlashAttention.backward (repro_torch.attn.bwd)"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run, SPAN, factor=2, reverse=True)

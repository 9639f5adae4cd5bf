"""attn_fwd_roofline.infer: Kernel 1's share of its roofline in inference:
each call's bound (its unit's work for it) summed over the device time
launched inside the program's ``repro_torch.attn.fwd`` spans; the count is
each request's own work, so a wave's padding counts against it. A program
without the span reads nothing."""
from portbench import readers

SPAN = "repro_torch.attn.fwd"
LAYER = "Kernels: kernels/ops.py flash_attention -> csrc/flashbias_attn.cu"
UNIT = "%"
MOVES = "infer_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run, SPAN)

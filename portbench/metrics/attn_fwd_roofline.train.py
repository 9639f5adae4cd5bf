"""attn_fwd_roofline.train: Kernel 1's share of its roofline in the training
step: each forward call's bound (the remat recompute's included) summed
over the device time launched inside the program's ``repro_torch.attn.fwd``
spans. A program without the span reads nothing."""
from portbench import readers

SPAN = "repro_torch.attn.fwd"
LAYER = "Kernels: kernels/ops.py flash_attention -> csrc/flashbias_attn.cu"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run, SPAN)

"""attn_fwd_roofline.train: Kernel 1's share of its roofline in the training
step (forward calls, the remat recompute's included)."""
from portbench import readers

LAYER = "Kernels: kernels/ops.py flash_attention -> csrc/flashbias_attn.cu"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run)

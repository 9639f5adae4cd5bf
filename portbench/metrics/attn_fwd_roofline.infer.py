"""attn_fwd_roofline.infer: Kernel 1's share of its roofline in inference;
the count is each request's own work, so a wave's padding counts against
it."""
from portbench import readers

LAYER = "Kernels: kernels/ops.py flash_attention -> csrc/flashbias_attn.cu"
UNIT = "%"
MOVES = "infer_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run)

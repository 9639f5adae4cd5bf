"""attn_bound_ms.pair: The least time of a request's attention calls, in ms:
each call of the program's ``repro_torch.attn.fwd`` paired with its own
work (a list, one per block), its bounds summed over the window's calls,
over the requests. A program without the span reads nothing."""
from portbench import readers, yardstick

SPAN = "repro_torch.attn.fwd"
LAYER = "Kernels: kernels/ops.py flash_attention -> csrc/flashbias_attn.cu"
UNIT = "ms"
MOVES = "infer_tokens_per_s"
BETTER = "lower"


def read(run):
    if run.trace is None or not run.trace.ranges(SPAN):
        return None
    bound = sum(yardstick.bound_seconds(w["flops"], w["bytes"])
                for *_, w in readers.call_works(run, SPAN))
    return 1e3 * bound / len(run.units)

"""idle_share.infer: The share of the traced window in which no device
operation ran."""
from portbench import readers

LAYER = "Device (H100)"
UNIT = "%"
MOVES = "infer_tokens_per_s"
BETTER = "lower"


def read(run):
    return readers.idle_share(run)

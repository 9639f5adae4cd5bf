"""mfu.infer: The forward's share of the card's bf16 peak."""
from portbench import readers

LAYER = "Model step: models/pde.py"
UNIT = "%"
MOVES = "infer_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.mfu(run)

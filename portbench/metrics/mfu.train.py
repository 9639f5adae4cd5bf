"""mfu.train: The whole training step's share of the card's bf16 peak."""
from portbench import readers

LAYER = "Model step: models/pde.py"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(run):
    return readers.mfu(run)

"""backward_share.train: The backward's share of the device's busy time."""
from portbench import readers

LAYER = "Training step: train/step.py, ops._FlashAttention backward, optim/adamw.py"
UNIT = "%"
MOVES = "train_tokens_per_s"
BETTER = "lower"


def read(run):
    return readers.backward_share(run)

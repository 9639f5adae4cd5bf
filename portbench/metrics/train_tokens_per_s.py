"""train_tokens_per_s: Mesh points (tokens) of every optimizer
step completed in the window, over the time from the first step's start to
the last one's synchronised end."""
from portbench import readers

UNIT = "tokens/s"
BETTER = "higher"


def read(run):
    return readers.rate(run)

"""infer_tokens_per_s: Mesh points (tokens) of every request completed in
the window, over the window."""
from portbench import readers

UNIT = "tokens/s"
BETTER = "higher"


def read(run):
    return readers.rate(run)

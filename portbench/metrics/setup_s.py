"""setup_s: Time from the process's start to the first measured step:
imports, weights made on the card, warm-up, and on a fresh checkout the
kernels' build."""
UNIT = "s"
BETTER = "lower"


def read(run):
    return run.setup_s

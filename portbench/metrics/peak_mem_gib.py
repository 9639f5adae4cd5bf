"""peak_mem_gib: The most device memory the program held during the window
(``torch.cuda.max_memory_allocated`` after a reset at the end of set-up):
weights, optimizer state, cache and activations."""
from portbench import yardstick

UNIT = "GiB"
BETTER = "lower"


def read(run):
    return run.peak_bytes / yardstick.GIB if run.peak_bytes else None

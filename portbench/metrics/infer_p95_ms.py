"""infer_p95_ms: The 95th percentile over all requests completed in the
window, each timed from when the client sent it to when its result is on the
host."""
from portbench import readers

UNIT = "ms"
BETTER = "lower"


def read(run):
    return readers.p95_ms(run)

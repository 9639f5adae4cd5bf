"""The CPU sizes of every cell in ``BENCHMARK.json``, read from data (the
cells' own sizes are in ``traffic/``):

- ``smoke(cell)``: traffic overrides for a run at the program's smoke
  config, the ``"smoke"`` object of the cell's traffic file;
- ``control(cell)``: ``(traffic, config)`` overrides for the control at the
  configuration's full widths, from ``controls/<cell>.json``.

A cell without them raises, so the test of that cell fails by name."""
from portbench import harness

CELLS = [w["name"] for w in harness.bench()["workloads"]]


def smoke(cell: str) -> dict:
    w = harness.workload(harness.bench(), cell)
    traffic = harness.load_json("traffic", f"{w['traffic']}.json")
    if "smoke" not in traffic:
        raise KeyError(f"{cell}: traffic/{w['traffic']}.json has no "
                       "\"smoke\" sizes for a run on the CPU")
    return traffic["smoke"]


def control(cell: str) -> tuple:
    c = harness.load_json("controls", f"{cell}.json")
    return c["traffic"], c["config"]

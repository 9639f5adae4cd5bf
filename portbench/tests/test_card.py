"""On the card, at each cell's own size: a short sound run is correct, and
the cell's control (the plain reference in float8 in the program's place)
is not. Skips where there is no card; the README names the command that
runs these on the chip."""
import time

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.bench()["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    _card()
    ctx = harness.context(cell, 2 ** 31 + 101, 3.0, False)
    out = harness.run(ctx, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _card()
    checks = harness.control(harness.context(cell, 2 ** 31 + 103, 1.0,
                                             False))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

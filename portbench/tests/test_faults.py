"""A run on the CPU that skips the look for a card and drives the rest of
the harness on the program's smoke size: sound, it is correct; with each
fault its cell's check must catch planted under the timed path, it is not
(the cells' limits, set on the card, hold at this size too)."""
import time

import pytest

from portbench import harness
from portbench.tests import small

def _faults(cell):
    ctx = harness.context(cell, 1, 0.1, False, device="cpu", smoke=True)
    return harness.driver_of(ctx).faults(ctx)


CASES = [(cell, fault) for cell in small.CELLS
         for fault in (None,) + _faults(cell)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_check_catches_the_fault(cell, fault):
    ctx = harness.context(cell, 2 ** 31 + 17, 0.3, False, device="cpu",
                          smoke=True, traffic_overrides=small.smoke(cell))
    out = harness.run(ctx, time.perf_counter(), fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] >= 1
    assert "setup_s" in out["metrics"]
    if fault is None:
        assert out["failed"] == 0


def test_training_check_sees_a_turned_gradient():
    """A step-1 gradient of the right norm that points elsewhere passes
    ``grad_gap`` and fails ``grad_diff``."""
    import torch
    from portbench.drivers import train
    g = {("a",): torch.tensor([3.0, 4.0]), ("b",): torch.tensor([1.0, 0.0])}
    turned = {("a",): torch.tensor([4.0, 3.0]), ("b",): g[("b",)]}
    ref = {"loss": [1.0], "grad": g, "update": {("a",): 1.0, ("b",): 1.0}}
    prog = dict(ref, grad=turned)
    got = train.compare(prog, ref)
    assert got["grad_gap"] == 0.0 and got["update_gap"] == 0.0
    assert got["grad_diff"] == pytest.approx(2 ** 0.5 / 5)
    assert got["grad_diff"] > harness.load_json(
        "limits", "pde_solver.train.json")["grad_diff"]

"""Each cell's control, the plain reference computed in float8 put in the
program's place, comes out not correct against the cell's limits at a
size a CPU holds: the configuration's full widths and fewer points than
the cells send (``controls/<cell>.json``; ``test_card.py`` runs the
controls at the cells' own sizes on the card)."""
import pytest

from portbench import harness
from portbench.tests import small


@pytest.mark.parametrize("cell", small.CELLS)
def test_control_is_not_correct(cell):
    import torch
    torch.set_num_threads(4)
    traffic, config = small.control(cell)
    ctx = harness.context(cell, 2 ** 31 + 3, 1.0, False, device="cpu",
                          traffic_overrides=traffic,
                          config_overrides=config)
    checks = harness.control(ctx)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks

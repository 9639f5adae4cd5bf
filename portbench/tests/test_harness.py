"""The harness finds everything of every cell in ``BENCHMARK.json`` by
name, the accepted cells among them, and a metric added as a new file is
found without an edit (``test_new_family.py`` adds a whole family)."""
import json
import shutil

import pytest

from portbench import harness, port
from portbench.tests import small

# the cells of accepted benchmarks: each must stay; more may come
ACCEPTED = ["pde_solver.infer", "pde_solver.train"]


def test_the_accepted_cells_are_present():
    assert set(ACCEPTED) <= set(small.CELLS)


@pytest.mark.parametrize("cell", small.CELLS)
def test_every_cell_resolves_by_name(cell):
    b = harness.bench()
    w = harness.workload(b, cell)
    spec = harness.load_json("configs", f"{w['config']}.json")
    traffic = harness.load_json("traffic", f"{w['traffic']}.json")
    limits = harness.load_json("limits", f"{w['name']}.json")
    assert spec["name"] == w["config"]
    assert limits and all(v > 0 for v in limits.values())
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert (harness.HERE / "reference" / f"{spec['reference']}.py").exists()
    fam = port.family(spec)
    assert fam.WIDTHS and callable(fam.matmul_params)
    ctx = harness.context(cell, 1, 0.1, False, device="cpu", smoke=True)
    assert set(harness.driver_of(ctx).faults(ctx)) <= set(fam.FAULTS)
    assert small.smoke(cell) and small.control(cell)
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"portbench/configs/{w['config']}.json"
    assert conf["reduced"] == spec["reduced"]


@pytest.mark.parametrize("cell", small.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_metric_files_declare_their_entry(cell, trace):
    b = harness.bench()
    found = harness.cell_metrics(b, cell, trace)
    assert found
    for m in found:
        mod = harness.metric_reader(m["name"])
        assert (mod.UNIT, mod.BETTER) == (m["unit"], m["better"])
        if trace:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    if trace:      # each per-layer metric's cell reports what it moves
        e2e = {m["name"] for m in harness.cell_metrics(b, cell, False)}
        assert {m["moves"] for m in found} <= e2e
    else:
        assert "setup_s" in {m["name"] for m in found}


def test_a_new_metric_file_is_picked_up(tmp_path, monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here)
    b = harness.bench()
    b["per_layer"].append({
        "name": "tokens_per_unit.train", "unit": "tokens",
        "better": "higher", "source": "program_counter",
        "layer": "Training step", "moves": "train_tokens_per_s",
        "workloads": ["pde_solver.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (here / "metrics" / "tokens_per_unit.train.py").write_text(
        'LAYER = "Training step"\nUNIT = "tokens"\n'
        'MOVES = "train_tokens_per_s"\nBETTER = "higher"\n\n\n'
        'def read(run):\n    return run.units[0]["tokens"]\n')
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    names = [m["name"] for m in harness.cell_metrics(
        harness.bench(), "pde_solver.train", True)]
    assert "tokens_per_unit.train" in names
    assert "tokens_per_unit.train" not in [m["name"] for m in
                                           harness.cell_metrics(
                                               harness.bench(),
                                               "pde_solver.infer", True)]
    run = type("R", (), {"units": [{"tokens": 32186}]})
    assert harness.metric_reader("tokens_per_unit.train").read(run) == 32186


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.workload(harness.bench(), "no_such.cell")


def test_no_device_means_no_result(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoDevice):
        harness.context("pde_solver.infer", 1, 1.0, False)

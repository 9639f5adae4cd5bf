"""The port's examples run on the CPU at their demo sizes, a few steps
each (``--device cpu --steps 3``): the LM trainer's exactness check
(FlashBias-ALiBi loss == dense-ALiBi loss at init, which the script itself
enforces) and its loop, the neural decomposition's Eq. 5 fits of the
gravity and haversine biases, whose losses must fall, and the sharded
serve engine on a (2, 2) mesh of four ``gloo`` processes (the script
asserts the decode step's collectives and streams equal to the unsharded
engine's)."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_alibi_example(tmp_path, capsys):
    losses = _load("train_lm_alibi_torch").main(
        ["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "exactness check" in out and "run info" in out
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert any(p.is_dir() for p in tmp_path.iterdir())     # a checkpoint


def test_neural_decomposition_example(capsys):
    results = _load("neural_decomposition_torch").main(
        ["--device", "cpu", "--steps", "3"])
    assert set(results) == {"gravity", "spherical"}
    for first, last, rel in results.values():
        assert last < first and math.isfinite(rel)
    assert "held-out rel err" in capsys.readouterr().out


def test_serve_sharded_example():
    assert _load("serve_sharded_torch").main([]) == 0

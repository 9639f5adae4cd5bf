"""The port's examples run on the CPU at their demo sizes, a few steps
each (``--device cpu --steps 3``): the LM trainer's exactness check
(FlashBias-ALiBi loss == dense-ALiBi loss at init, which the script itself
enforces) and its loop, the neural decomposition's Eq. 5 fits of the
gravity and haversine biases, whose losses must fall, and the sharded
serve engine on a (2, 2) mesh of four ``gloo`` processes (the script
asserts the decode step's collectives and streams equal to the unsharded
engine's); the quickstart's three exactness checks (the ALiBi
factorization, FlashBias == dense-bias attention, the Eq. 3 concat
identity, each within the script's bound, which it enforces), the LM serve
engine over its three cache kinds, batched Pairformer serving, and the PDE
solver's factored-against-dense forward and 3 training steps."""
import importlib.util
import math
from pathlib import Path

import numpy as np
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


def test_quickstart_example(capsys):
    mod = _load("quickstart_torch")
    res = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("1. ALiBi factorization error", "2. FlashBias vs dense-bias",
                 "3. Eq.3 concat identity error", "4. Example 3.9"):
        assert line in out, out
    for key in ("factorization", "flashbias_vs_dense", "concat"):
        assert res[key] <= mod.TOL
    assert "(channels 64 -> 66)" in out and res["io_ratio"] > 1


def test_serve_lm_example(capsys):
    mod = _load("serve_lm_torch")
    res = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert set(res) == set(mod.ARCHS)
    for arch, results in res.items():
        assert len(results) == 5 and all(r.size == 12 for r in results)
    for name in ("stablelm-12b", "hymba-1.5b", "mamba2-130m"):
        assert f"{name}" in out and "(5 reqs / 2 slots)" in out
    assert "ssm_h:" in out and "k:(2, 2, 2, 32, 32)" in out  # hymba's ring


def test_serve_pairformer_example(capsys):
    mod = _load("serve_pairformer_torch")
    res = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [s.shape for s in res.values()] == [(n, 64) for n in mod.SIZES]
    assert all(np.isfinite(s).all() for s in res.values())
    assert "22 refinement steps" in out and "phi_q:" in out


def test_pde_solver_example(capsys):
    mod = _load("pde_solver_torch")
    losses = mod.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    gap = float(out.split("max |fb - dense| = ")[1].split()[0])
    assert gap <= mod.TOL
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)

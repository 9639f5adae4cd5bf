"""The port stands alone: no module of ``src/repro_torch`` (and not
``chip_smoke.py``) imports JAX or the JAX package, importing the port
builds no kernel, and its entry points default to the CUDA device —
raising, never falling back to the CPU, where there is none."""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch.kernels.build as kbuild
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_source_is_listed_and_present():
    sources = {p.stem for p in kbuild.CSRC.glob("*.cu")}
    assert sources == set(kbuild.KERNELS)
    for name in kbuild.KERNELS:
        assert kbuild.library_path(name).name.startswith(f"lib{name}-")


def test_engine_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(smoke_config("gpt2_alibi_15b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "gpt2_alibi_15b", "--smoke"])

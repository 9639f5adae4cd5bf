"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), the
references load nothing of the program, and ``benchmarks/`` (the JAX
package's own benchmark) is left as it was."""
import ast
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import small

ROOT = harness.ROOT

# one tiny run of every cell on the CPU (the program's smoke configs), then
# the loaded top-level names
_RUN_ALL = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
small = json.loads({small!r})
for cell, over in small.items():
    ctx = harness.context(cell, 7, 0.2, True, device="cpu", smoke=True,
                          traffic_overrides=over)
    harness.run(ctx, time.perf_counter())
    harness.control(ctx)
for m in harness.bench()["end_to_end"] + harness.bench()["per_layer"]:
    harness.metric_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    loaded = _loaded(_RUN_ALL.format(root=str(ROOT), src=str(ROOT / "src"),
                                     small=json.dumps({
                                         c: small.smoke(c)
                                         for c in small.CELLS})))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(
        harness.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    code = (f"import json, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import torch\n"
            "from portbench.reference import adamw, arith, pde\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    loaded = _loaded(code)
    assert not loaded & {"repro_torch", *harness.FORBIDDEN}


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_no_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"repro_torch", *harness.FORBIDDEN}
    assert all(n.startswith("portbench.reference") for n in names
               if n.startswith("portbench"))


def test_benchmarks_folder_is_untouched():
    if not (ROOT / ".git").exists():
        pytest.skip("not a git checkout: nothing to compare benchmarks/ with")
    diff = subprocess.run(["git", "status", "--porcelain", "--",
                           "benchmarks"], capture_output=True, text=True,
                          cwd=ROOT, check=True)
    assert diff.stdout == ""
    for path in harness.HERE.rglob("*.py"):
        if "tests" not in path.relative_to(harness.HERE).parts:
            assert "benchmarks" not in path.read_text(), path

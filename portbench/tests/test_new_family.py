"""A model family the benchmark lacks, added as new files only: the port's
pairformer_lite with its factor MLPs (``new_family/``: the configuration,
a traffic mix with its CPU sizes, limits, control sizes, a driver, a plain
reference, a family file with one fault, and a per-layer metric that
reads a unit's list of per-call works), and additions to
``BENCHMARK.json`` (the entries, and the cell's name in the end-to-end
metrics it reports). In a copy of the benchmark the harness then runs the
new cell on the CPU at the program's smoke size: sound it is correct and
the metric reads; with the fault, and as the control, it is not. Every
file that was there before is unchanged, and ``BENCHMARK.json`` changed
only by additions."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, yardstick

FIXTURE = Path(__file__).resolve().parent / "new_family"
CELL = "pairformer_lite.infer"

_RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(4)
from portbench import harness
from portbench.tests import small
out = {{}}
for name, trace, fault in (("sound", True, None),
                           ("fault", False, "answer_altered")):
    ctx = harness.context({cell!r}, 2 ** 31 + 29, 0.3, trace,
                          device="cpu", smoke=True,
                          traffic_overrides=small.smoke({cell!r}))
    out[name] = harness.run(ctx, time.perf_counter(), fault)
out["spec"] = ctx.spec
traffic, config = small.control({cell!r})
ctx = harness.context({cell!r}, 2 ** 31 + 31, 1.0, False, device="cpu",
                      traffic_overrides=traffic, config_overrides=config)
out["control"] = harness.control(ctx)
print(json.dumps(out))
"""


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def _only_added(old, new) -> bool:
    """Every key and list entry of ``old`` is in ``new`` unchanged; lists
    grow only at their end."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(
            k in new and _only_added(v, new[k]) for k, v in old.items())
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(
            _only_added(o, n) for o, n in zip(old, new))
    return old == new


def _add_family(root: Path) -> None:
    """The new family's files, each new, and its entries in
    ``BENCHMARK.json``."""
    for src in sorted(FIXTURE.rglob("*")):
        if src.is_file() and src.parent != FIXTURE:
            dst = root / "portbench" / src.relative_to(FIXTURE)
            assert not dst.exists(), dst
            dst.write_bytes(src.read_bytes())
    add = json.loads((FIXTURE / "add_to_benchmark.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        b[key] += add[key]
    for m in b["end_to_end"]:
        if m["name"] in add["end_to_end_workloads"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1) + "\n")


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    _add_family(root)
    run = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=str(root),
                                           src=str(harness.ROOT / "src"),
                                           cell=CELL)],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert run.returncode == 0, run.stderr[-4000:]
    return root, before, json.loads(run.stdout.strip().splitlines()[-1])


def test_only_new_files_and_additions(added):
    root, before, _ = added
    after = _digests(root)
    changed = [p for p, d in before.items() if after.get(p) != d]
    assert changed == ["BENCHMARK.json"]
    old = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    new = json.loads((root / "BENCHMARK.json").read_text())
    assert _only_added(old, new) and new != old


def test_the_sound_run_is_correct_and_the_metric_reads(added):
    _, _, out = added
    sound = out["sound"]
    assert sound["correct"] is True, sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    # one call a block, each paired with its own work
    s = out["spec"]
    n, h = 8, s["n_heads"]
    call = yardstick.attention_call(
        batch=1, heads=h, nq=n, nk=n, head_dim=s["d_model"] // h,
        rank=s["bias_rank"], causal=False,
        factor_bytes=4 * 2 * n * h * s["bias_rank"])
    assert s["n_layers"] == 2
    assert sound["metrics"]["attn_bound_ms.pair"]["value"] == pytest.approx(
        1e3 * 2 * yardstick.bound_seconds(call["flops"], call["bytes"]))


def test_the_fault_and_the_control_are_not_correct(added):
    _, _, out = added
    fault = out["fault"]
    assert fault["correct"] is False, fault["checks"]
    assert {"infer_tokens_per_s", "infer_p95_ms", "setup_s"} <= set(
        fault["metrics"])
    assert any(c["value"] > c["limit"] for c in out["control"].values()), \
        out["control"]

"""The port's dry run (``launch/dryrun.py``) held against its own real
runs on the CPU (the reference's own dry-run test fails on this jax:
``test_sharding.py::test_mini_multipod_lowering``, ROADMAP.md Queue C):

- at SMOKE size, for the dense, MoE, SSM and hybrid families x train,
  prefill and decode, and the PDE solver's loss: with ``attn_impl
  "torch"`` the step run on fake tensors and on real ones gives equal
  ``FlopCounterMode`` totals, equal bytes of the counting dispatch mode
  and equal ``MemTracker`` memory; with ``"io_stub"`` the outputs have
  the plain path's shapes and dtypes and each kernel's recorded calls
  equal the layer arithmetic (and the real run's equal the fake run's);
- the ``io_stub`` kernel terms: kernel 1's FLOPs over the pairs its mask
  allows, its tile re-reads, the decode kernels' whole-cache reads;
- on a fake ``(2, 2)`` mesh, GPT-2 SMOKE's train step records the
  collectives that ``check_train_step`` counts on four real ``gloo``
  ranks (52 all-gathers and 26 reduce-scatters), and rank 0's argument
  bytes are the real rank 0's local masters, moments and step plus the
  batch;
- the CLI on one full-size cell (``mamba2_130m x decode_32k x single``)
  writes a JSON that ``analysis.report`` turns into its tables;
- ``hillclimb`` with ``baseline`` and ``remat_full`` appends two records,
  and the full remat counts more FLOPs; every other change of its table
  moves the report of a cell its knob is read in.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_train_worker as W
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.sharding import Rules
from repro_torch.kernels import io_stub
from repro_torch.launch import dryrun
from repro_torch.models import init_params

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 32, 4
CASES = [(arch, kind) for arch in ("gpt2_alibi_15b", "granite_moe_3b_a800m",
                                   "mamba2_130m", "hymba_15b")
         for kind in ("train", "prefill", "decode")] + [("pde_solver",
                                                         "train")]
K1, K3, K5 = "flashbias_attention_fwd", "flash_decode_fwd", "ssd_scan_fwd"


@pytest.fixture(autouse=True)
def _no_world():
    yield
    dryrun.release_world()


def layer_calls(cfg, kind: str) -> dict:
    """Kernel calls of one step by the layer arithmetic: one per layer
    (per microbatch, twice under remat in training) for each kernel the
    family's layer runs; a ring cache's decode (a cache of at most
    ``window`` rows) runs none."""
    attn = cfg.family in ("dense", "moe", "hybrid", "pde")
    ssm = cfg.family in ("ssm", "hybrid")
    per = cfg.n_layers
    if kind == "train":
        per *= cfg.grad_accum * (1 if cfg.remat == "none" else 2)
    if kind == "decode":
        ring = bool(cfg.window) and cfg.window <= SEQ   # lm._is_ring
        return {K3: per} if attn and not ring else {}
    return {**({K1: per} if attn else {}), **({K5: per} if ssm else {})}


def _layout(out):
    return [(tuple(t.shape), t.dtype) for t in dryrun.tensors(out)]


@pytest.mark.parametrize("arch,kind", CASES)
def test_fake_run_equals_real_run(arch, kind):
    cfg = smoke_config(arch)
    shape = ShapeSpec("t", SEQ, BATCH, kind)
    runs = {(impl, fake): dryrun.run_step(cfg.replace(attn_impl=impl), shape,
                                          None, Rules(), fake=fake)
            for impl in ("torch", "io_stub") for fake in (True, False)}
    fake, real = runs["torch", True], runs["torch", False]
    assert fake["flops"] == real["flops"] > 0
    assert fake["bytes"] == real["bytes"] > 0
    assert fake["memory"] == real["memory"]
    assert fake["memory"]["peak_bytes"] > fake["memory"]["argument_bytes"] \
        > 0
    assert fake["kernels"] == real["kernels"] == {}
    stub = runs["io_stub", True]
    assert _layout(stub["out"]) == _layout(fake["out"])
    calls = {k: v["calls"] for k, v in stub["kernels"].items()}
    assert calls == layer_calls(cfg, kind)
    assert {k: v["calls"] for k, v in
            runs["io_stub", False]["kernels"].items()} == calls
    # in inference the stub's kernels replace the plain path's aten FLOPs
    # (a training backward recomputes the plain path on either)
    if calls and kind != "train":
        assert stub["flops"] < fake["flops"]


def test_io_stub_kernel_terms():
    """Kernel 1 causal, local and unmasked, and kernel 3, against their
    counts by hand."""
    b, h, n, d = 2, 4, 200, 16
    assert io_stub.allowed_pairs(n, n, "none", 0, n) == n * n
    assert io_stub.allowed_pairs(n, n, "causal", 0, n) == n * (n + 1) // 2
    assert io_stub.allowed_pairs(n, n, "local", 8, n) == \
        sum(min(i + 1, 8) for i in range(n))
    q, k, v = (torch.zeros(b, h, n, d, dtype=torch.bfloat16)
               for _ in range(3))
    slopes = torch.ones(h)
    io_stub.reset()
    out = io_stub.flashbias_attention_fwd(q, k, v, slopes=slopes,
                                          scale=0.25, mask_kind="causal")
    assert out.shape == q.shape and out.dtype == q.dtype
    t = io_stub.terms()[K1]
    assert t["calls"] == 1
    assert t["flops"] == b * h * n * (n + 1) // 2 * (4 * d + 4)
    assert t["bytes"] == 4 * q.numel() * 2 + h * 4
    # 4 query blocks of 64 rows see 1, 2, 3 and 4 key tiles of 64
    tile = 64 * 2 * d * 2
    assert t["reread_bytes"] == b * h * (10 * tile) - b * h * n * 2 * d * 2
    io_stub.reset()
    kvh, g, s = 2, 2, 96
    qd = torch.zeros(b, kvh, g, d)
    kc, vc = (torch.zeros(b, kvh, s, d) for _ in range(2))
    lens = torch.full((b,), 50, dtype=torch.int32)
    o = io_stub.flash_decode_fwd(qd, kc, vc, lens, scale=0.25)
    assert o.shape == qd.shape
    t = io_stub.terms()[K3]
    assert t["flops"] == b * kvh * g * s * 4 * d
    assert t["bytes"] == (2 * kc.numel() + 2 * qd.numel()) * 4 + b * 4


def test_io_stub_paged_and_ragged_paths():
    """``ops`` routes the paged decode and the ragged attention to their
    wrappers' stubs: the plain path's output shapes, one call each, the
    paged call charged the table's full width."""
    from repro_torch.kernels import ops
    b, kvh, g, d, ps, n_pages, width = 2, 2, 2, 16, 4, 6, 3
    q = torch.zeros(b, 1, kvh * g, d)
    pool = torch.zeros(kvh, n_pages, ps, d)
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    io_stub.reset()
    got = ops.flash_decode(q, pool, pool, lens, impl="io_stub",
                           page_table=table, kv_layout="bhsd")
    want = ops.flash_decode(q, pool, pool, lens, impl="torch",
                            page_table=table, kv_layout="bhsd")
    assert got.shape == want.shape and got.dtype == want.dtype
    t = io_stub.terms()["flash_decode_paged_fwd"]
    assert t["calls"] == 1 and t["flops"] == b * kvh * g * width * ps * 4 * d
    x = torch.zeros(b, 8, 2, d)
    phi = torch.zeros(b, 8, 2, 3)
    got = ops.flash_attention(x, x, x, phi, phi, impl="io_stub",
                              lengths=torch.tensor([8, 5]))
    assert got.shape == x.shape
    assert io_stub.terms()["flashbias_attention_ragged_fwd"]["calls"] == 1


def test_other_impls_call_the_wrappers_as_before(monkeypatch):
    """``impl="io_stub"`` reaches the stubs of ``kernels.io_stub`` and no
    wrapper; ``"cuda"`` calls the wrappers by their module names with
    their own signatures, so stand-ins for them (the card's in-situ
    checks) keep working."""
    from repro_torch.kernels import ops
    seen = []

    def stand_in(name, real):
        def call(*a, **kw):
            seen.append(name)
            return real(*a, **kw)
        return call
    for name in (K1, K3):
        monkeypatch.setattr(ops, name, stand_in(name, getattr(ops, name)))
    q = torch.randn(1, 8, 2, 16)
    cache = torch.zeros(1, 8, 2, 16)
    io_stub.reset()
    for impl in ("io_stub", "cuda"):
        ops.flash_attention(q, q, q, slopes=torch.ones(2),
                            mask_kind="causal", impl=impl)
        ops.flash_decode(q[:, :1], cache, cache, torch.tensor([3]),
                         impl=impl)
    assert seen == [K1, K3]
    assert {k: v["calls"] for k, v in io_stub.terms().items()} == \
        {K1: 1, K3: 1}


def _gloo_statcheck(tmp: Path):
    """Start the four ranks of ``statcheck:gpt2`` on a ``gloo`` (2, 2)."""
    arch = W.CASES["gpt2"][0]
    gen = torch.Generator().manual_seed(0)
    params = init_params(W.case_config("gpt2"), gen, device="cpu")
    np.savez(tmp / f"{arch}.npz", **{k: v.numpy() for k, v in
                                     W._flat(params).items()})
    out = tmp / "out"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_worker.py"),
         "--init", f"file://{tmp}/store", "--rank", str(r), "--world", "4",
         "--mesh", "2x2", "--params", str(tmp), "--out", str(out),
         "--jobs", "statcheck:gpt2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    return out, procs


def test_fake_mesh_collectives_equal_gloo(tmp_path):
    out, procs = _gloo_statcheck(tmp_path)
    try:
        cfg = W.case_config("gpt2").replace(attn_impl="torch")
        shape = ShapeSpec("t", W.SEQ, W.BATCH, "train")
        mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
        res = dryrun.run_step(cfg, shape, mesh, Rules())
    finally:
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), logs
    got = json.loads((out / "rank0.json").read_text())["statcheck:gpt2"]
    assert got["findings"] == []
    names = {"all-gather": "all_gather_into_tensor",
             "reduce-scatter": "reduce_scatter_tensor",
             "all-reduce": "all_reduce"}
    fake = {}
    for op, _, size, axes in res["collectives"]:
        fake[names[op]] = fake.get(names[op], 0) + 1
        # each axis of the (2, 2) mesh, or both (the gradient norm's sum)
        assert axes in (("data",), ("model",), ("data", "model"))
        assert size == 2 ** len(axes)
    assert fake == {k: v for k, v in got["counts"].items() if v}
    assert (fake["all_gather_into_tensor"],
            fake["reduce_scatter_tensor"]) == (52, 26)
    batch = 2 * W.BATCH * W.SEQ * 8                 # tokens + labels, int64
    assert res["memory"]["argument_bytes"] == got["tree_bytes"] + batch


def test_cli_cell_and_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2_130m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "0 failures" in run.stdout
    rep = json.loads((tmp_path / "mamba2_130m.decode_32k.single.json")
                     .read_text())
    assert rep["devices"] == 256 and rep["mesh_shape"] == [32, 8]
    assert rep["chip"] == "h100-sxm" and rep["dominant"] == "memory_s"
    assert rep["kernels"] == {}                 # SSM decode: no kernel
    assert rep["memory"]["peak_bytes"] >= rep["memory"]["argument_bytes"] > 0
    from repro_torch.analysis import report
    table = report.roofline_table(report.load(str(tmp_path)))
    assert "| mamba2-130m | decode_32k |" in table
    assert "| mamba2-130m |" in report.collective_breakdown(
        report.load(str(tmp_path)))


def test_hillclimb_appends_records(tmp_path, monkeypatch):
    from repro_torch.configs import base
    from repro_torch.launch import hillclimb
    monkeypatch.setattr(hillclimb, "get_config", lambda a: smoke_config(a)
                        .replace(grad_accum=2))
    monkeypatch.setitem(base.SHAPES, "train_4k",
                        ShapeSpec("train_4k", 32, 256, "train"))
    for change in ("baseline", "remat_full"):
        hillclimb.main(["--arch", "gpt2_alibi_15b", "--shape", "train_4k",
                        "--change", change, "--hypothesis", f"h {change}",
                        "--out", str(tmp_path)])
    lines = (tmp_path / "gpt2_alibi_15b.train_4k.jsonl").read_text() \
        .splitlines()
    base_rep, full = (json.loads(line) for line in lines)
    assert (base_rep["change"], full["change"]) == ("baseline", "remat_full")
    assert full["hypothesis"] == "h remat_full"
    assert full["hlo_flops_per_device"] > base_rep["hlo_flops_per_device"]
    assert full["adjusted_flops_per_device"] > \
        base_rep["adjusted_flops_per_device"]
    assert full["kernels"][K1]["calls"] == 2 * base_rep["kernels"][K1][
        "calls"]


# the SMOKE cell each hill-climb change is held to move: GPT-2 at no remat,
# Mamba2 at "dots" with a sequence of several SSD chunks
MOVES = {"no_tp": "gpt2_alibi_15b", "remat_dots": "gpt2_alibi_15b",
         "remat_full": "gpt2_alibi_15b", "remat_none": "mamba2_130m",
         "ssd_128": "mamba2_130m", "ssd_512": "mamba2_130m",
         "accum_half": "gpt2_alibi_15b", "accum_double": "gpt2_alibi_15b",
         "mesh_16_2_8": "gpt2_alibi_15b"}
_BASELINES: dict = {}


def _hillclimb_report(arch: str, change: str) -> dict:
    """The deployment pass of ``run_cell`` (``with_cost=False``: memory,
    kernel terms, the io_stub's aten terms) on one layer of ``arch``'s
    SMOKE config under ``change``."""
    from repro_torch.launch import hillclimb
    cfg = smoke_config(arch).replace(
        n_layers=1, grad_accum=2,
        remat="dots" if arch == "mamba2_130m" else "none")
    cfg, rules, mesh = hillclimb.CHANGES[change](cfg)
    seq = 512 if arch == "mamba2_130m" else 32
    with pytest.MonkeyPatch.context() as mp:
        from repro_torch.configs import base
        mp.setitem(base.SHAPES, "train_4k",
                   ShapeSpec("train_4k", seq, 256, "train"))
        rep = dryrun.run_cell(arch, "train_4k", multi_pod=False, rules=rules,
                              cfg_override=cfg, mesh_override=mesh,
                              with_cost=False, verbose=False)
    dryrun.release_world()
    return json.loads(json.dumps({k: v for k, v in rep.items()
                                  if k != "run_s"}, default=str))


@pytest.mark.parametrize("change", sorted(MOVES))
def test_hillclimb_change_moves_its_cell(change):
    """No change of ``CHANGES`` is a no-op: each moves some field of its
    cell's report against the baseline's (ROADMAP.md names the
    reference's changes the port does not offer)."""
    from repro_torch.launch import hillclimb
    assert set(MOVES) == set(hillclimb.CHANGES) - {"baseline"}
    arch = MOVES[change]
    if arch not in _BASELINES:
        _BASELINES[arch] = _hillclimb_report(arch, "baseline")
    rep = _hillclimb_report(arch, change)
    assert [k for k in rep if rep[k] != _BASELINES[arch][k]]

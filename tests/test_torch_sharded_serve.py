"""The port's sharded serve engine on the CPU, in real multi-process runs:
4 ``gloo`` ranks on a ``(2, 2)`` ``(data, model)`` mesh, and 2 ranks each
on ``(1, 2)`` and ``(2, 1)`` (``tests/torch_dist_worker.py``; the three
worlds start together, each rank with one thread and a 120 s limit).

Every rank serves each scenario's six staggered requests (two sampled)
through the unsharded engine and the sharded one, on the JAX reference's
SMOKE parameters, and the tests hold the sharded engine to:

- streams, greedy and sampled, identical to the unsharded port engine's;
  statuses and ``page_stats()`` equal;
- the logits of every sampling call, and each rank's state shards (caches,
  page pools and their replicas over ``data``, SSM state, lengths, the last
  tokens) against the unsharded engine's state cut the same way, at fp32
  rtol 1e-5, atol 1e-5 — not bit-equal: the sums over ranks after ``wo``,
  the FFN and the MoE combine reorder float32 additions (the reference
  claims bit-identical outputs under GSPMD; ROADMAP.md lists the
  difference);
- ``check_backend_mesh``: the state axes in the vocabulary, no pool leaf
  replicated by the divisibility rule, and the decode step's all-reduce
  (``model`` = 2) and all-gather (``data`` = 2);
- greedy streams of three scenarios equal to the JAX engine's.

The scenarios cover the dense family (contiguous, paged + chunked, prefix
cached, 3 slots on 2 data ranks, where ``batch`` replicates), GPT-2 ALiBi
(each rank's slopes are those of its own heads), the MoE family (5 experts
on 2 ranks: ``expert`` replicates, the heads split), the SSM family (split
on ``batch`` only) and the hybrid (ring, and paged). The ``units`` run
checks ``shard_put``'s placements and replication rule, ``constrain`` and
the kernel wrappers' refusal of a DTensor on the same mesh.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_dist_worker as W
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine

WORKER = Path(__file__).resolve().with_name("torch_dist_worker.py")
ALL = tuple(W.SCENARIOS)
MESHES = {
    "2x2": ALL + ("units",),
    "1x2": ("stablelm_paged_chunked", "gpt2_alibi_contiguous", "granite_moe",
            "mamba2", "hymba_ring"),
    "2x1": ("stablelm_contiguous", "stablelm_prefix", "gpt2_alibi_paged",
            "stablelm_paged_3_slots", "mamba2_chunked", "hymba_paged"),
}
CASES = [(m, s) for m, names in MESHES.items() for s in names
         if s != "units"]
JAX_CHECKED = ("stablelm_paged_chunked", "gpt2_alibi_contiguous", "mamba2")
TOL = 1e-5


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_params(arch: str):
    jmodel = jget_model(jsmoke(arch).replace(attn_impl="xla"))
    return jmodel, jinit(jmodel.template(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: [rank results]}: the three worlds, started together."""
    tmp = tmp_path_factory.mktemp("sharded")
    for arch in W.ARCHS:
        np.savez(tmp / f"{arch}.npz",
                 **_flat(jax.tree.map(np.asarray, _jax_params(arch)[1])))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(WORKER.parents[1] / "src"))
    procs = {}
    for mesh, names in MESHES.items():
        d, m = (int(v) for v in mesh.split("x"))
        out = tmp / f"out_{mesh}"
        out.mkdir()
        procs[mesh] = (out, [subprocess.Popen(
            [sys.executable, str(WORKER), "--init",
             f"file://{tmp}/store_{mesh}", "--rank", str(r), "--world",
             str(d * m), "--mesh", mesh, "--params", str(tmp), "--out",
             str(out), "--scenarios", ",".join(names)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(d * m)])
    results, failed = {}, []
    for mesh, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            try:
                log, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
            if p.returncode:
                failed.append(f"{mesh} rank {r} exit {p.returncode}:\n"
                              f"{log[-3000:]}")
        results[mesh] = [json.loads((out / f"rank{r}.json").read_text())
                         if (out / f"rank{r}.json").exists() else {}
                         for r in range(len(ps))]
    assert not failed, "\n".join(failed)
    return results


@pytest.mark.parametrize("mesh,name", CASES, ids=[f"{m}-{s}"
                                                  for m, s in CASES])
def test_sharded_engine_matches_unsharded(runs, mesh, name):
    for rank, res in enumerate(runs[mesh]):
        got = res[name]
        where = f"{mesh} rank {rank}"
        assert got["streams"] == got["ref_streams"], where
        assert got["statuses"] == got["ref_statuses"] and set(
            got["statuses"]) == {"OK"}, where
        assert got["page_stats"] == got["ref_page_stats"], where
        calls, ref_calls = got["sample_calls"]
        assert calls == ref_calls > 0, where
        assert got["logit_gap"] <= TOL, (where, got["logit_gap"])
        for key, gap in got["state_gaps"].items():
            assert isinstance(gap, float) and gap <= TOL, (where, key, gap)
        assert not got["findings"], (where, got["findings"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_hold_their_shards(runs, mesh):
    """Every rank of a world holds the same streams; the slot rows split
    over ``data`` (all rows where 3 slots do not split over 2 ranks), and
    the K/V state splits its heads over ``model``."""
    d, m = (int(v) for v in mesh.split("x"))
    ranks = runs[mesh]
    for name in MESHES[mesh]:
        if name == "units":
            continue
        streams = {json.dumps(r[name]["streams"]) for r in ranks}
        assert len(streams) == 1, name
        n_slots = W.SCENARIOS[name][1].get("n_slots", 4)
        for rank, res in enumerate(ranks):
            lo, hi = res[name]["rows"]
            if n_slots % d:
                assert (lo, hi) == (0, n_slots), name
            else:
                step = n_slots // d
                assert (lo, hi) == ((rank // m) * step,
                                    (rank // m + 1) * step), name
            placed = res[name]["placements"]
            if m > 1 and "pages_k" in placed:    # (L, KVH, pages, ps, hd)
                assert placed["pages_k"] == ["Replicate()",
                                             "Shard(dim=1)"], name
            elif m > 1 and "k" in placed:        # (L, B, KVH, S, hd)
                assert placed["k"][-1] == "Shard(dim=2)", name


def test_units_on_the_mesh(runs):
    for rank, res in enumerate(runs["2x2"]):
        units = res["units"]
        assert units["shard_put"] == {
            "batch,heads 4x6": ["(Shard(dim=0), Shard(dim=1))", [2, 3]],
            "batch,heads 3x6": ["(Replicate(), Shard(dim=1))", [3, 3]],
            "batch,mlp 4x5": ["(Shard(dim=0), Replicate())", [2, 5]],
            "layers,kv_heads 2x4": ["(Replicate(), Shard(dim=1))", [2, 2]],
        }, rank
        assert units["constrain"] == {"inside": "(Shard(dim=0), "
                                      "Replicate())", "outside": True}, rank
        assert units["refused"] == sorted(W.WRAPPERS), rank


def _jax_streams(name: str):
    arch, kw, lens, shared = W.SCENARIOS[name]
    jmodel, jparams = _jax_params(arch)
    kw = dict(kw)
    eng = JServeEngine(jmodel, jparams, n_slots=kw.pop("n_slots", 4), **kw)
    reqs = W.requests(jsmoke(arch).vocab, lens, shared)
    half = len(reqs) // 2

    def submit(p, sp):
        return eng.submit(p, W.NEW_TOKENS, sampling=JSamplingParams(
            sp.temperature, sp.top_k, seed=sp.seed))
    rids = [submit(p, sp) for p, sp in reqs[:half]]
    pending = list(reqs[half:])
    while len(eng.scheduler) or eng.occupancy or pending:
        if pending:
            rids.append(submit(*pending.pop(0)))
        eng.step()
    return [np.asarray(eng.result(r)).tolist() for r in rids]


@pytest.mark.parametrize("name", JAX_CHECKED)
def test_greedy_streams_equal_the_jax_engine(runs, name):
    want = _jax_streams(name)
    for mesh, names in MESHES.items():
        if name not in names:
            continue
        for res in runs[mesh]:
            got = res[name]["streams"]
            for i, (a, b) in enumerate(zip(got, want)):
                if i not in W.SAMPLED:
                    assert a == b, (mesh, name, i)


def test_launcher_serves_on_a_2x2_mesh(tmp_path):
    """``launch.serve --mesh 2x2 --device cpu`` in a world of 4 (the
    environment torchrun sets, a file rendezvous): every request ``OK``,
    printed by rank 0 alone."""
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="4",
               PYTHONPATH=str(WORKER.parents[1] / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "stablelm_12b", "--smoke", "--device", "cpu", "--mesh", "2x2",
            "--init-method", f"file://{tmp_path}/store", "--page-size", "4",
            "--prefill-chunk", "8", "--requests", "6", "--new-tokens", "8"]
    procs = [subprocess.Popen(args, env=dict(env, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    assert [p.returncode for p in procs] == [0] * 4, outs[0][1][-2000:]
    assert "cpu mesh 2x2" in outs[0][0]
    assert "lifecycle: OK=6;" in outs[0][0]
    assert all(not out for out, _ in outs[1:])


def test_launcher_mesh_needs_its_world(monkeypatch, capsys):
    from repro_torch.launch import serve as launch_serve
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "stablelm_12b", "--smoke", "--device",
                           "cpu", "--mesh", "2x2"])
    assert "needs a world of 4 ranks" in capsys.readouterr().err

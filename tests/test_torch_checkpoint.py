"""The port's crash-safe engine checkpoint on the CPU (the counterpart of the
checkpoint tests of ``tests/test_faults.py``).

``_roundtrip``: an uninterrupted run; a twin stepped part way, snapshotted,
put through ``json.dumps`` / ``json.loads`` and restored onto a fresh
engine, which must finish every request OK and bit-equal to the
uninterrupted run, greedy and sampled; the snapshotted engine, run on, must
give the same streams (the snapshot does not perturb it). The drill runs on
the full (``stablelm_12b``), ring (``hymba_15b``) and SSM (``mamba2_130m``)
cache families, on a paged + chunked + prefix-cached engine caught with a
prompt mid-``ChunkPlan`` and two requests sharing prefix pages, and on the
Pairformer. The restored greedy streams also equal the JAX engine's
uninterrupted ones (the reference's parameters carried across).

Then the lifecycle records (OK / REJECTED / CANCELLED, the rid sequence
continuing) and the refusals: another config (naming the differing key),
an engine that is not fresh, another version, and a snapshot the JAX engine
wrote (its sampling-stream state is a threefry key, not the port's).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import (
    CANCELLED,
    OK,
    QUEUED,
    REJECTED,
    RUNNING,
    SamplingParams,
    ServeEngine,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(arch):
    jcfg = jsmoke(arch).replace(attn_impl="xla")
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


@pytest.fixture(scope="module")
def stablelm():
    return _carried("stablelm_12b")


def _prompts(vocab, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _roundtrip(make_engine, submit_all, steps_before):
    """Returns (the JSON-loaded snapshot, the uninterrupted results)."""
    ref = make_engine()
    rids = submit_all(ref)
    ref.run()
    want = [ref.result(r) for r in rids]

    src = make_engine()
    assert submit_all(src) == rids
    for _ in range(steps_before):
        src.step()
    state = json.loads(json.dumps(src.snapshot_engine()))

    dst = make_engine()
    dst.restore_engine(state)
    assert RUNNING not in {dst.status(r) for r in rids}
    dst.run()
    for rid, w in zip(rids, want):
        got = dst.result(rid)
        assert got.status == OK
        np.testing.assert_array_equal(got, w)

    src.run()                              # the snapshot perturbed nothing
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(src.result(rid), w)
    return state, want


def _mixed(prompts, budgets, sampling=SamplingParams):
    """Alternating greedy / sampled submissions."""
    def go(eng):
        return [eng.submit(p, b, sampling=sampling(float(i % 2), 0, seed=i))
                for i, (p, b) in enumerate(zip(prompts, budgets))]
    return go


def _greedy_match_reference(jmodel, jparams, kw, prompts, budgets, want):
    """The restored (= uninterrupted) greedy streams equal the JAX engine's
    uninterrupted ones; its sampled rows are left out (the packages' random
    streams differ by design)."""
    jeng = JServeEngine(jmodel, jparams, **kw)
    rids = _mixed(prompts, budgets, JSamplingParams)(jeng)
    jeng.run()
    for i in range(0, len(rids), 2):
        np.testing.assert_array_equal(want[i], np.asarray(jeng.result(
            rids[i])), err_msg=f"request {i}")


FAMILIES = {
    "full": ("stablelm_12b", dict(max_len=64, n_slots=2, prefill_len=12)),
    "ring": ("hymba_15b", dict(max_len=48, n_slots=2, prefill_len=12)),
    "ssm": ("mamba2_130m", dict(max_len=48, n_slots=2, prefill_len=12)),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_checkpoint_restore_bit_identical(name):
    arch, kw = FAMILIES[name]
    jmodel, jparams, model, params = _carried(arch)
    prompts = _prompts(model.cfg.vocab, (5, 9, 12, 7), seed=3)
    budgets = (6, 8, 5, 7)
    state, want = _roundtrip(
        lambda: ServeEngine(model, params, device="cpu", **kw),
        _mixed(prompts, budgets), steps_before=3)
    assert state["live"]                         # caught with work in flight
    _greedy_match_reference(jmodel, jparams, kw, prompts, budgets, want)


def test_checkpoint_restore_ring_past_the_window():
    """A ring slot snapshotted after its prompt + generated tokens passed
    the window re-prefills them through the ring gather."""
    jmodel, jparams, model, params = _carried("hymba_15b")
    w = model.cfg.window
    kw = dict(max_len=48, n_slots=2)
    prompts = _prompts(model.cfg.vocab, (w - 2, 9, w + 5), seed=4)
    budgets = (10, 6, 8)
    state, want = _roundtrip(
        lambda: ServeEngine(model, params, device="cpu", **kw),
        _mixed(prompts, budgets), steps_before=5)
    assert max(len(d["tokens"]["data"]) for d in state["live"]) > w
    _greedy_match_reference(jmodel, jparams, kw, prompts, budgets, want)


def test_checkpoint_restore_paged_chunked_prefix_mid_plan(stablelm):
    """Paged + chunked + prefix cache, snapshotted while one prompt is
    mid-ChunkPlan and two requests share prefix pages."""
    model, params = stablelm[2], stablelm[3]
    rng = np.random.RandomState(9)
    vocab = model.cfg.vocab
    head = rng.randint(0, vocab, (16,)).astype(np.int32)
    prompts = [
        np.concatenate([head, rng.randint(0, vocab, (8,)).astype(np.int32)]),
        np.concatenate([head, rng.randint(0, vocab, (4,)).astype(np.int32)]),
        rng.randint(0, vocab, (26,)).astype(np.int32),     # the mid-plan one
    ]
    kw = dict(max_len=64, n_slots=3, page_size=4, n_pages=32,
              prefill_chunk=4, prefix_cache=True)
    seen = {}

    def make():
        eng = ServeEngine(model, params, device="cpu", **kw)
        seen.setdefault("engines", []).append(eng)
        return eng

    def submit_all(eng):
        rids = [eng.submit(prompts[0], 9)]
        for _ in range(6):              # its 24 tokens land and are indexed
            eng.step()
        return rids + [
            eng.submit(prompts[1], 7, sampling=SamplingParams(1.0, 0, seed=1)),
            eng.submit(prompts[2], 5)]

    state, want = _roundtrip(make, submit_all, steps_before=2)
    src = seen["engines"][1]
    assert src.page_stats()["prefix"]["tokens_matched"] >= 16   # shared
    # all three live; the third caught mid-plan serialized whole, unemitted
    assert [d["rid"] for d in state["live"]] == [0, 1, 2]
    assert state["live"][2]["tokens"]["data"] == prompts[2].tolist()
    dst = seen["engines"][2]
    pool, prefix = dst.backend._pool, dst.backend._prefix
    index_pages = {e.page for e in prefix._entries.values()}
    assert pool.n_used == len(index_pages)          # pages balance
    assert all(pool.refcount(p) == 1 for p in index_pages)


def test_checkpoint_restore_pairformer():
    _, _, model, params = _carried("pairformer_lite")
    rng = np.random.RandomState(2)
    feats = [rng.standard_normal((n, 64)).astype(np.float32)
             for n in (12, 7, 9)]

    def submit_all(eng):
        return [eng.submit(f, b) for f, b in zip(feats, (3, 5, 4))]

    state, _ = _roundtrip(
        lambda: ServeEngine(model, params, max_len=16, n_slots=2,
                            device="cpu"),
        submit_all, steps_before=2)
    assert state["live"] and state["live"][0]["key_override"] is None


def test_checkpoint_preserves_lifecycle_records(stablelm):
    model, params = stablelm[2], stablelm[3]
    eng = ServeEngine(model, params, max_len=32, n_slots=1, device="cpu")
    prompts = _prompts(model.cfg.vocab, (5, 6, 30))
    done = eng.submit(prompts[0], 3)
    eng.run()
    live = eng.submit(prompts[1], 20)
    dead = eng.submit(prompts[2], 4, strict=False)   # REJECTED: 30+4 > 32
    cancelled = eng.submit(prompts[0], 5)
    eng.step()
    eng.cancel(cancelled)
    state = json.loads(json.dumps(eng.snapshot_engine()))

    dst = ServeEngine(model, params, max_len=32, n_slots=1, device="cpu")
    dst.restore_engine(state)
    assert dst.status(done) == OK
    np.testing.assert_array_equal(dst.result(done), eng.result(done))
    assert dst.status(dead) == REJECTED
    assert dst.result(dead).error["kind"] == "admission"
    assert dst.status(cancelled) == CANCELLED
    assert dst.status(live) == QUEUED                # resumes as preempted
    dst.run()
    eng.run()
    assert dst.status(live) == OK and dst.result(live).size == 20
    np.testing.assert_array_equal(dst.result(live), eng.result(live))
    assert dst.submit(prompts[0], 1) == cancelled + 1   # rid sequence goes on


def test_restore_refuses_mismatch_reuse_version_and_reference(stablelm):
    jmodel, jparams, model, params = stablelm
    eng = ServeEngine(model, params, max_len=32, n_slots=2, device="cpu")
    state = eng.snapshot_engine()
    assert state["version"] == 1 and state["format"] == "repro_torch.serve"

    other = ServeEngine(model, params, max_len=48, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="config mismatch.*max_len"):
        other.restore_engine(state)

    used = ServeEngine(model, params, max_len=32, n_slots=2, device="cpu")
    used.submit(_prompts(model.cfg.vocab, (4,))[0], 2)
    with pytest.raises(ValueError, match="fresh engine"):
        used.restore_engine(state)

    fresh = ServeEngine(model, params, max_len=32, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="snapshot version"):
        fresh.restore_engine(dict(state, version=99))

    jeng = JServeEngine(jmodel, jparams, max_len=32, n_slots=2)
    jeng.submit(_prompts(model.cfg.vocab, (4,))[0], 2)
    jeng.step()
    jstate = json.loads(json.dumps(jeng.snapshot_engine()))
    assert jstate["version"] == state["version"]
    with pytest.raises(ValueError, match="snapshot format"):
        fresh.restore_engine(jstate)
    assert not fresh._results and not len(fresh.scheduler)

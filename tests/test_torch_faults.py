"""The port's fault injection and containment on the CPU (the counterpart of
``tests/test_faults.py`` classes ``TestFaultPlan``, ``TestQuarantine`` and
``TestContainment``, the admission-delay, stall and randomized chaos
tests), on ``stablelm_12b`` SMOKE (float32) with ``device="cpu"``.

- ``FaultPlan``: the grammar, its round trip and refusals, the per-step
  queries and firing log, and ``FaultPlan.random`` drawing the reference's
  specs for the same seed.
- Cross-package: the same plan string and the same greedy traffic through
  the port's engine and the JAX engine (the reference's parameters carried
  across) give equal statuses, streams, ``fired`` logs and preemption /
  quarantine / contained counts — ``nan`` (retried and exhausted),
  ``step``, ``alloc`` and ``delay``.
- In-port: faulted runs equal fault-free runs bit for bit, greedy and
  sampled; pages are conserved; a quarantined slot's prefix pages leave the
  index; guards off let the poison through; the stall guard trips.
- A seeded chaos drill (random traffic, cancels, preemptions and a random
  plan of every kind) ends with every request terminal and every page free
  or held once by the prefix index.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import (
    FAILED,
    OK,
    TERMINAL_STATUSES,
    EngineStalled,
    FaultPlan,
    FaultSpec,
    SamplingParams,
    ServeEngine,
)

ARCH = "stablelm_12b"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def carried():
    jcfg = jsmoke(ARCH).replace(attn_impl="xla")
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


def _prompts(vocab, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


PAGED = {"max_len": 48, "n_slots": 2, "page_size": 4, "n_pages": 24}


def _port(carried, plan=None, **kw):
    return ServeEngine(carried[2], carried[3], device="cpu",
                       faults=None if plan is None else FaultPlan.parse(plan),
                       **{**PAGED, **kw})


def _jax(carried, plan=None, **kw):
    return JServeEngine(carried[0], carried[1],
                        faults=(None if plan is None
                                else JFaultPlan.parse(plan)),
                        **{**PAGED, **kw})


def _drill(eng, prompts, budget, samplings=None, **sub):
    samplings = samplings or [None] * len(prompts)
    rids = [eng.submit(p, budget, sampling=s, **sub)
            for p, s in zip(prompts, samplings)]
    eng.run()
    return [eng.result(r) for r in rids]


def _summary(eng, recs) -> dict:
    return {"status": [r.status for r in recs],
            "streams": [np.asarray(r).tolist() for r in recs],
            "fired": list(eng.faults.fired) if eng.faults else [],
            "counts": (eng.n_preemptions, eng.n_quarantines,
                       eng.n_faults_contained)}


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_parse_grammar_and_roundtrip(self):
        plan = FaultPlan.parse("nan@12/0, alloc@5x3, step@20, delay@1/2x2")
        assert plan.specs == (FaultSpec("nan", 12, slot=0),
                              FaultSpec("alloc", 5, count=3),
                              FaultSpec("step", 20),
                              FaultSpec("delay", 1, slot=2, count=2))
        assert FaultPlan.parse(plan.spec_str()).specs == plan.specs
        assert plan.spec_str() == JFaultPlan.parse(
            "nan@12/0, alloc@5x3, step@20, delay@1/2x2").spec_str()
        assert FaultPlan.parse(None).specs == ()
        assert FaultPlan.parse("  ").specs == ()

    def test_bad_specs_rejected(self):
        with pytest.raises(ValueError, match="bad fault spec"):
            FaultPlan.parse("nan12")
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultPlan.parse("oom@3")
        with pytest.raises(ValueError, match="count >= 1"):
            FaultSpec("nan", 2, count=0)

    def test_queries_follow_tick_and_log_firings(self):
        plan = FaultPlan.parse("alloc@2x2,nan@3/1,delay@9")
        plan.tick(1)
        assert not plan.alloc_fails() and plan.nan_slots() == []
        plan.tick(2)
        assert plan.alloc_fails() and not plan.step_fails()
        plan.tick(3)
        assert plan.alloc_fails() and plan.nan_slots() == [1]
        plan.tick(4)
        assert not plan.alloc_fails()
        assert plan.fired == [(2, "alloc", -1), (3, "alloc", -1),
                              (3, "nan", 1)]

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_random_plans_match_reference(self, seed):
        got = FaultPlan.random(seed, n_steps=40, n_slots=4, n_faults=6)
        want = JFaultPlan.random(seed, n_steps=40, n_slots=4, n_faults=6)
        assert got.spec_str() == want.spec_str()
        assert got.specs == FaultPlan.random(seed, n_steps=40, n_slots=4,
                                             n_faults=6).specs
        assert got.specs != FaultPlan.random(seed + 1, n_steps=40, n_slots=4,
                                             n_faults=6).specs


# ---------------------------------------------------------------------------
# Cross-package: the port's engine against the JAX engine under one plan
# ---------------------------------------------------------------------------

CROSS = {
    "nan-retry": ("nan@3/0", (6, 9), 8, {}),
    "nan-exhaust": ("nan@2/0x30", (6, 9), 8, {}),
    "step": ("step@2x3", (6, 9), 8, {}),
    "alloc": ("alloc@1x8", (6, 7), 12, {"n_pages": 16}),
    "delay": ("delay@0x3", (5, 8), 6, {}),
    "every-kind": ("delay@1,alloc@3x2,nan@5/1,step@7", (6, 7), 12,
                   {"n_pages": 16}),
}


@pytest.mark.parametrize("case", list(CROSS))
def test_faulted_engine_matches_reference_engine(carried, case):
    plan, lens, budget, kw = CROSS[case]
    prompts = _prompts(carried[2].cfg.vocab, lens)
    port = _port(carried, plan, **kw)
    jeng = _jax(carried, plan, **kw)
    got = _summary(port, _drill(port, prompts, budget, max_retries=1))
    want = _summary(jeng, _drill(jeng, prompts, budget, max_retries=1))
    assert got == want
    assert got["fired"]                             # the plan did fire
    assert port.backend._pool.n_free == port.n_pages


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------

SAMPLINGS = [SamplingParams(0.0, 0, seed=0), SamplingParams(1.0, 0, seed=1)]


class TestQuarantine:
    def test_nan_injection_retries_bit_identically(self, carried):
        """One injected NaN step: the poisoned request quarantines, its
        snapshot resumes, and every stream, greedy and sampled, equals the
        fault-free run's."""
        prompts = _prompts(carried[2].cfg.vocab, (6, 9))
        ref = _drill(_port(carried), prompts, 8, SAMPLINGS)
        eng = _port(carried, "nan@3/0")
        got = _drill(eng, prompts, 8, SAMPLINGS)
        assert (3, "nan", 0) in eng.faults.fired
        assert eng.n_quarantines == 1
        assert eng.page_stats()["quarantines"] == 1
        for g, w in zip(got, ref):
            assert g.status == OK
            np.testing.assert_array_equal(g, w)
        assert eng.backend._pool.n_free == eng.n_pages

    def test_nan_poisons_the_logits_on_the_device(self, carried):
        """The injection writes NaN into the logits the guard reads (not a
        host flag): the guard's detail reports the NaN row maximum."""
        eng = _port(carried, "nan@2/0", n_slots=1)
        rid = eng.submit(_prompts(carried[2].cfg.vocab, (6,))[0], 6,
                         max_retries=0)
        eng.run()
        rec = eng.result(rid)
        assert rec.status == FAILED and rec.error["kind"] == "guard"
        assert "nan)) at slot 0" in rec.error["detail"]
        assert eng.n_quarantines == 1 and eng.n_preemptions == 0

    def test_retries_exhaust_to_failed_with_structured_error(self, carried):
        prompts = _prompts(carried[2].cfg.vocab, (6, 9))
        eng = _port(carried, "nan@2/0x30")
        a = eng.submit(prompts[0], 8, max_retries=1)
        b = eng.submit(prompts[1], 8)
        eng.run()
        ra = eng.result(a)
        assert ra.status == FAILED
        assert ra.error["kind"] == "guard" and ra.error["retries"] == 1
        assert "non-finite" in ra.error["detail"]
        assert eng.result(b).status == OK           # neighbour unharmed
        assert eng.n_quarantines == 2               # initial trip + retry
        assert eng.backend._pool.n_free == eng.n_pages

    def test_guards_off_lets_poison_through(self, carried):
        eng = _port(carried, "nan@2/0", n_slots=1, guards=False)
        rid = eng.submit(_prompts(carried[2].cfg.vocab, (6,))[0], 6)
        eng.run()
        rec = eng.result(rid)
        assert rec.status == OK and eng.n_quarantines == 0   # undetected

    def test_quarantine_invalidates_written_prefix_pages(self, carried):
        """A poisoned slot's landed prompt pages leave the index, and the
        same prompt re-lands cleanly afterwards."""
        prompt = _prompts(carried[2].cfg.vocab, (16,), seed=5)[0]
        eng = _port(carried, "nan@6/0x2", n_slots=1, max_len=64,
                    prefill_chunk=4, prefix_cache=True)
        rid = eng.submit(prompt, 6, max_retries=0)
        eng.run()
        assert eng.result(rid).status == FAILED
        stats = eng.page_stats()
        assert stats["prefix"]["invalidated"] >= 4   # the prompt chain
        assert stats["prefix"]["entries"] == 0
        assert eng.backend._pool.n_free == eng.n_pages
        rid2 = eng.submit(prompt, 6)
        eng.run()
        assert eng.result(rid2).status == OK
        assert eng.page_stats()["prefix"]["entries"] == 4


# ---------------------------------------------------------------------------
# Containment
# ---------------------------------------------------------------------------

class TestContainment:
    @pytest.mark.parametrize("sampled", [False, True],
                             ids=["greedy", "sampled"])
    def test_step_fault_contained_and_bit_identical(self, carried, sampled):
        prompts = _prompts(carried[2].cfg.vocab, (6, 9))
        samplings = SAMPLINGS[::-1] if sampled else None
        ref = _drill(_port(carried), prompts, 8, samplings)
        eng = _port(carried, "step@2x3")
        got = _drill(eng, prompts, 8, samplings)
        assert eng.n_faults_contained == 3
        assert [f[1] for f in eng.faults.fired] == ["step"] * 3
        for g, w in zip(got, ref):
            assert g.status == OK
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("sampled", [False, True],
                             ids=["greedy", "sampled"])
    def test_alloc_fault_preempts_instead_of_crashing(self, carried,
                                                      sampled):
        prompts = _prompts(carried[2].cfg.vocab, (6, 7))
        samplings = SAMPLINGS if sampled else None
        ref = _drill(_port(carried, n_pages=16), prompts, 12, samplings)
        eng = _port(carried, "alloc@1x8", n_pages=16)
        got = _drill(eng, prompts, 12, samplings)
        assert any(k == "alloc" for _, k, _ in eng.faults.fired)
        assert eng.n_faults_contained >= 1 and eng.n_preemptions >= 1
        for g, w in zip(got, ref):
            assert g.status == OK
            np.testing.assert_array_equal(g, w)
        assert eng.backend._pool.n_free == eng.n_pages


def test_admission_delay_fault_only_defers(carried):
    eng = _port(carried, "delay@0x3", n_slots=1)
    rid = eng.submit(_prompts(carried[2].cfg.vocab, (5,))[0], 3)
    eng.run()
    assert eng.result(rid).status == OK
    assert [f[1] for f in eng.faults.fired] == ["delay"] * 3


def test_stall_guard_raises_with_diagnostics(carried):
    eng = ServeEngine(carried[2], carried[3], max_len=32, n_slots=1,
                      device="cpu", faults=FaultPlan.parse("delay@0x500"),
                      stall_limit=5)
    eng.submit(_prompts(carried[2].cfg.vocab, (5,))[0], 3)
    with pytest.raises(EngineStalled, match="no progress for 5"):
        eng.run()


# ---------------------------------------------------------------------------
# Randomized chaos drill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_chaos_conserves_pool_and_terminates(carried, seed):
    """~60 engine steps of seeded random traffic (mixed greedy / sampled,
    staggered arrivals) with random cancels, forced preemptions and a
    random plan of every kind. Afterwards every request is terminal, no
    slot is occupied, and every page is free or held by the prefix index
    alone, refcount exactly 1."""
    plan = FaultPlan.random(seed, n_steps=50, n_slots=3, n_faults=6)
    eng = ServeEngine(carried[2], carried[3], max_len=64, n_slots=3,
                      page_size=4, n_pages=28, prefill_chunk=4,
                      prefix_cache=True, faults=plan, stall_limit=300,
                      device="cpu")
    rng = np.random.RandomState(seed + 1000)
    rids = []
    for _ in range(60):
        if len(rids) < 12 and rng.rand() < 0.4:
            prompt = rng.randint(0, eng.model.cfg.vocab,
                                 (int(rng.randint(3, 20)),)).astype(np.int32)
            rids.append(eng.submit(
                prompt, int(rng.randint(2, 10)),
                sampling=SamplingParams(float(rng.rand() < 0.5), 0,
                                        seed=len(rids)),
                max_retries=2,
                deadline_steps=None if rng.rand() < 0.7 else 40))
        if rids and rng.rand() < 0.1:
            victim = rids[int(rng.randint(len(rids)))]
            if eng.status(victim) not in TERMINAL_STATUSES:
                assert eng.cancel(victim) is True
        if eng.occupancy and rng.rand() < 0.1:
            eng.preempt()
        eng.step()
    eng.run()

    assert rids and eng.occupancy == 0
    counts = eng.status_counts()
    assert sum(counts.values()) == len(rids)
    assert set(counts) <= TERMINAL_STATUSES
    for rid in rids:
        rec = eng.result(rid)
        if rec.status == OK:
            assert rec.size >= 1
    pool, prefix = eng.backend._pool, eng.backend._prefix
    assert not eng.backend._slot_pages
    index_pages = {e.page for e in prefix._entries.values()}
    assert pool.n_used == len(index_pages)
    for page in index_pages:
        assert pool.refcount(page) == 1


def test_launcher_injects_faults_and_prints_them(capsys):
    from repro_torch.launch import serve as launch_serve
    recs = launch_serve.main([
        "--arch", "gpt2_alibi_15b", "--smoke", "--device", "cpu",
        "--page-size", "4", "--pool-pages", "24",
        "--inject-fault", "nan@4/0,alloc@3x2"])
    out = capsys.readouterr().out
    assert "[serve] fault fired: nan@4 slot 0" in out
    assert "[serve] fault fired: alloc@" in out
    assert "faults contained" in out and "lifecycle: OK=8;" in out
    assert len(recs) == 8 and all(r.status == OK for r in recs)

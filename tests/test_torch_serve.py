"""The port's serve engine on the CPU: greedy token streams against the JAX
engine on the same staggered schedule, and the engine's in-port contracts
(sampled streams independent of batch packing, lifecycle statuses, cancel,
deadlines, bit-identical preemption resume, guard quarantine) plus the
constructor arguments that belong to later slices (paged serving is in
``test_torch_paged.py``)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import (
    CANCELLED,
    FAILED,
    OK,
    QUEUED,
    REJECTED,
    RUNNING,
    TIMED_OUT,
    AdmissionRejected,
    SamplingParams,
    ServeEngine,
    sample_tokens,
)

PF = 12                      # pinned prefill_len
KW = {"max_len": 64, "n_slots": 2, "prefill_len": PF}
SAMPLED = SamplingParams(temperature=0.7, top_k=5, seed=42)


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
def gpt2():
    cfg = smoke_config("gpt2_alibi_15b")
    params = params_from_numpy(jax.tree.map(np.asarray, jinit(
        jget_model(jsmoke("gpt2_alibi_15b")).template(),
        jax.random.PRNGKey(0))), cfg, device="cpu")
    return get_model(cfg), params


def _prompts(vocab, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _staggered(eng, prompts, budgets, samplings=None):
    samplings = samplings or [None] * len(prompts)
    r0 = eng.submit(prompts[0], budgets[0], sampling=samplings[0])
    r1 = eng.submit(prompts[1], budgets[1], sampling=samplings[1])
    eng.step()
    eng.step()
    r2 = eng.submit(prompts[2], budgets[2], sampling=samplings[2])
    eng.step()
    r3 = eng.submit(prompts[3], budgets[3], sampling=samplings[3])
    eng.run()
    return [eng.result(r) for r in (r0, r1, r2, r3)]


def _alone(model, params, prompt, budget, sampling=None):
    eng = ServeEngine(model, params, device="cpu", **KW)
    rid = eng.submit(prompt, budget, sampling=sampling)
    eng.run()
    return eng.result(rid)


@pytest.mark.parametrize("arch", ["gpt2_alibi_15b", "stablelm_12b"])
def test_greedy_streams_match_reference_engine(arch):
    jmodel, jparams, model, params = _carried(arch)
    prompts = _prompts(model.cfg.vocab, (5, 9, 7, 12))
    budgets = [8, 5, 10, 6]
    want = _staggered(JServeEngine(jmodel, jparams, **KW), prompts, budgets)
    got = _staggered(ServeEngine(model, params, device="cpu", **KW),
                     prompts, budgets)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == OK and g.size == budgets[i]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


def test_sampled_stream_independent_of_batch_packing(gpt2):
    model, params = gpt2
    prompts = _prompts(model.cfg.vocab, (5, 9, 7, 12))
    budgets = [8, 5, 10, 6]
    samplings = [None, SAMPLED, None,
                 SamplingParams(temperature=1.0, top_k=0, seed=7)]
    packed = _staggered(ServeEngine(model, params, device="cpu", **KW),
                        prompts, budgets, samplings)
    for i in (1, 3):
        alone = _alone(model, params, prompts[i], budgets[i], samplings[i])
        np.testing.assert_array_equal(packed[i], alone, err_msg=f"req {i}")
    greedy = _alone(model, params, prompts[1], budgets[1])
    assert not np.array_equal(packed[1], greedy)   # sampling did sample


@pytest.mark.parametrize("sampling", [None, SAMPLED], ids=["greedy",
                                                          "sampled"])
def test_preempt_resumes_bit_identically(gpt2, sampling):
    model, params = gpt2
    prompts = _prompts(model.cfg.vocab, (6, 10))
    want = _alone(model, params, prompts[0], 9, sampling)
    eng = ServeEngine(model, params, device="cpu", **KW)
    rid = eng.submit(prompts[0], 9, sampling=sampling)
    other = eng.submit(prompts[1], 4)
    for _ in range(4):
        eng.step()
    assert eng.preempt(rid) == rid
    assert eng.status(rid) == QUEUED and eng.n_preemptions == 1
    eng.run()
    np.testing.assert_array_equal(eng.result(rid), want)
    assert eng.result(other).status == OK


def test_lifecycle_cancel_deadline_and_rejection(gpt2):
    model, params = gpt2
    p = _prompts(model.cfg.vocab, (5, 6, 7, 8))
    eng = ServeEngine(model, params, device="cpu", **KW)
    a = eng.submit(p[0], 20)
    b = eng.submit(p[1], 20, deadline_steps=3)
    c = eng.submit(p[2], 5)                     # queued behind two slots
    assert eng.status(a) == QUEUED
    eng.step()
    assert eng.status(a) == RUNNING and eng.status(c) == QUEUED
    assert eng.cancel(c) and eng.status(c) == CANCELLED
    eng.step()
    assert eng.cancel(a) and eng.status(a) == CANCELLED
    assert eng.result(a).size == 3             # partial result kept
    assert not eng.cancel(a)                   # already terminal
    eng.run()
    rec = eng.result(b)
    assert rec.status == TIMED_OUT and rec.error["kind"] == "deadline"
    assert 0 < rec.size < 20
    with pytest.raises(AdmissionRejected):
        eng.submit(p[3], 60)                   # prompt + budget > max_len
    r = eng.submit(np.arange(PF + 1) % model.cfg.vocab, 2, strict=False)
    assert eng.status(r) == REJECTED and eng.result(r).error
    assert eng.status_counts() == {CANCELLED: 2, TIMED_OUT: 1, REJECTED: 1}


def _poison_once(eng, slot, at_call):
    """Make the backend's ``at_call``-th sampling see NaN logits in
    ``slot`` (a non-finite model output), once."""
    orig, calls = eng.backend._sample, [0]

    def sample(logits2d, mask):
        calls[0] += 1
        if calls[0] == at_call:
            logits2d = logits2d.clone()
            logits2d[slot] = float("nan")
        return orig(logits2d, mask)
    eng.backend._sample = sample


@pytest.mark.parametrize("sampling", [None, SAMPLED], ids=["greedy",
                                                          "sampled"])
def test_guard_quarantines_and_retries_bit_identically(gpt2, sampling):
    model, params = gpt2
    prompt = _prompts(model.cfg.vocab, (7,))[0]
    want = _alone(model, params, prompt, 8, sampling)
    eng = ServeEngine(model, params, device="cpu", **KW)
    _poison_once(eng, slot=0, at_call=4)
    rid = eng.submit(prompt, 8, sampling=sampling)
    eng.run()
    assert eng.n_quarantines == 1
    rec = eng.result(rid)
    assert rec.status == OK
    np.testing.assert_array_equal(rec, want)


def test_guard_fails_request_after_retries(gpt2):
    model, params = gpt2
    prompt = _prompts(model.cfg.vocab, (7,))[0]
    eng = ServeEngine(model, params, device="cpu", **KW)
    _poison_once(eng, slot=0, at_call=3)
    rid = eng.submit(prompt, 8, max_retries=0)
    eng.run()
    rec = eng.result(rid)
    assert rec.status == FAILED and rec.error["kind"] == "guard"
    assert rec.size == 2                        # emissions before the trip


def test_guards_off_lets_poison_through(gpt2):
    model, params = gpt2
    prompt = _prompts(model.cfg.vocab, (7,))[0]
    eng = ServeEngine(model, params, device="cpu", guards=False, **KW)
    _poison_once(eng, slot=0, at_call=3)
    rid = eng.submit(prompt, 8)
    eng.run()
    assert eng.n_quarantines == 0
    assert eng.result(rid).status == OK and eng.result(rid).size == 8


@pytest.mark.parametrize("kwarg", [
    {"page_size": 16, "prefix_cache": True}, {"prefill_chunk": 8},
    {"prefix_cache": True}, {"mesh": object()}, {"faults": object()}])
def test_later_slice_arguments_raise(gpt2, kwarg):
    model, params = gpt2
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        ServeEngine(model, params, device="cpu", **KW, **kwarg)


def test_checkpoint_is_a_later_slice(gpt2):
    model, params = gpt2
    eng = ServeEngine(model, params, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.snapshot_engine()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.restore_engine({})


def test_generate_fills_after_eos(gpt2):
    model, params = gpt2
    prompts = _prompts(model.cfg.vocab, (5, 9))
    first = _alone(model, params, prompts[0], 6)
    eng = ServeEngine(model, params, device="cpu", eos_id=int(first[2]),
                      **KW)
    out = eng.generate(prompts, 6)
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out[0, :3], first[:3])
    assert (out[0, 3:] == first[2]).all()


def test_sampler_contracts():
    rng = np.random.default_rng(0)
    v, vocab = 40, 33
    logits = torch.tensor(rng.standard_normal((3, v)), dtype=torch.float32)
    logits[:, vocab:] = 100.0                  # padding ids must never win
    zeros = np.zeros(3)
    greedy = sample_tokens(logits, zeros, zeros, zeros, zeros, vocab)
    np.testing.assert_array_equal(greedy.numpy(),
                                  logits[:, :vocab].argmax(-1).numpy())
    temps = np.full(3, 0.9, np.float32)
    seeds, counts = np.array([5, 5, 6]), np.array([2, 2, 2])
    top1 = sample_tokens(logits, temps, np.ones(3), seeds, counts, vocab)
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    same = logits.clone()
    same[1] = same[0]
    draw = sample_tokens(same, temps, zeros, seeds, counts, vocab)
    assert draw[0] == draw[1]                  # (seed, count) decides
    seen = {int(sample_tokens(logits, temps, zeros, seeds, np.full(3, c),
                              vocab)[0]) for c in range(40)}
    assert len(seen) > 3 and max(seen) < vocab
    topk = {int(sample_tokens(logits, temps, np.full(3, 3), seeds,
                              np.full(3, c), vocab)[0]) for c in range(40)}
    assert topk <= set(logits[0, :vocab].topk(3).indices.tolist())

"""The port's serve engine against the reference's on configurations and
inputs the other port tests leave out, on the CPU.

On ``gpt2_alibi_15b`` and ``mamba2_130m`` SMOKE (the reference's
parameters carried across with ``params_from_numpy``), each engine runs the
same mix on the same schedule under

- ``scheduler_policy="spf"`` (shortest prompt first),
- an ``eos_id`` that a greedy stream emits (taken from the reference's own
  fifo run), so that a request ends early,
- a paged pool small enough that growth preempts (``gpt2_alibi_15b``; for
  the SSM family ``page_size`` is a no-op and both report no pages),

with edge inputs in the mix: a prompt of ``max_len`` tokens, an empty
prompt, a budget of 0 and a budget past ``max_len`` (submitted with
``strict=False``, so a refused request ends ``REJECTED``). Greedy streams,
statuses and ``page_stats()`` must be equal. The same edge inputs submitted
with ``strict=True`` must be refused by both engines or by neither.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import AdmissionRejected as JAdmissionRejected
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import AdmissionRejected, ServeEngine

ARCHS = ["gpt2_alibi_15b", "mamba2_130m"]
MAX_LEN = 24
BASE = {"max_len": MAX_LEN, "n_slots": 2}
CONFIGS = {
    "spf": {"scheduler_policy": "spf"},
    "eos": {},                       # eos_id from the reference's fifo run
    "paged pool that preempts": {"page_size": 4, "n_pages": 5},
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    arch = request.param
    jcfg = jsmoke(arch).replace(attn_impl="xla")
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return arch, jmodel, jparams, get_model(cfg), params


def _mix(vocab):
    """(prompt, budget) pairs: ordinary requests of several lengths around
    the four edge inputs."""
    rng = np.random.RandomState(3)

    def prompt(n):
        return rng.randint(0, vocab, (n,)).astype(np.int32)

    return [(prompt(9), 6), (prompt(5), 7), (prompt(MAX_LEN), 4),
            (prompt(0), 3), (prompt(7), 0), (prompt(6), MAX_LEN + 10),
            (prompt(3), 5), (prompt(11), 4)]


def _drive(eng, mix):
    """Two requests, two steps, then the rest at once (so that the policy
    picks among several queued requests), run to the end; (status, tokens)
    per request."""
    rids = []
    for i, (p, b) in enumerate(mix):
        rids.append(eng.submit(p, b, strict=False))
        if i == 1:
            eng.step()
            eng.step()
    eng.run()
    return [(eng.result(r).status, np.asarray(eng.result(r)).tolist())
            for r in rids]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_matches_reference_on_edges(carried, config):
    arch, jmodel, jparams, model, params = carried
    mix = _mix(model.cfg.vocab)
    kw = dict(CONFIGS[config])
    if config == "eos":
        # a token the first request's greedy stream emits third
        fifo = _drive(JServeEngine(jmodel, jparams, **BASE), mix)
        kw["eos_id"] = int(fifo[0][1][2])
    jeng = JServeEngine(jmodel, jparams, **BASE, **kw)
    eng = ServeEngine(model, params, device="cpu", **BASE, **kw)
    want, got = _drive(jeng, mix), _drive(eng, mix)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{arch} {config} request {i}: {g} != {w}"
    assert eng.page_stats() == jeng.page_stats()
    if config == "eos":
        assert len(got[0][1]) < mix[0][1]           # ended at the eos
    if config == "paged pool that preempts" and arch == "gpt2_alibi_15b":
        assert eng.page_stats()["preemptions"] >= 1
        assert eng.backend._pool.n_free == eng.n_pages
    assert {s for s, _ in got} >= {"OK", "REJECTED"}


EDGES = {
    "prompt of max_len": (MAX_LEN, 4),
    "empty prompt": (0, 3),
    "budget 0": (7, 0),
    "budget past max_len": (6, MAX_LEN + 10),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_strict_admission_matches_reference(carried, edge):
    arch, jmodel, jparams, model, params = carried
    n, budget = EDGES[edge]
    prompt = np.random.RandomState(4).randint(
        0, model.cfg.vocab, (n,)).astype(np.int32)
    jeng = JServeEngine(jmodel, jparams, **BASE)
    eng = ServeEngine(model, params, device="cpu", **BASE)
    try:
        jrid = jeng.submit(prompt, budget)
    except JAdmissionRejected:
        jrid = None
    try:
        rid = eng.submit(prompt, budget)
    except AdmissionRejected:
        rid = None
    assert (rid is None) == (jrid is None), f"{arch} {edge}"
    if rid is not None:
        jeng.run()
        eng.run()
        assert eng.result(rid).status == jeng.result(jrid).status
        np.testing.assert_array_equal(eng.result(rid),
                                      np.asarray(jeng.result(jrid)))

"""The paged hybrid against the JAX reference, on the CPU, float32, at SMOKE
size: ``hymba_15b`` (2 layers, d_model 128, 4 heads x 32 over 2 kv heads,
SSM state 8) with ``window=0`` and with its window of 32, which covers the
engines' ``max_len`` of 24, so neither keeps a ring and both page.

The reference's parameters are carried across with ``params_from_numpy``;
prompts and tokens come from numpy; the reference runs its XLA path.

- ``init_paged_cache``: the reference's leaf set, shapes and dtypes (the
  pools, the factor slab, the page table and the per-slot SSM leaves).
- ``insert_paged_cache_at_slots`` of a prefilled wave (a padding row whose
  slot is out of range, sentinel table entries) and then
  ``grow_page_tables_at_slots``: every leaf at ``1e-5``.
- Paged ``decode_step`` (one slot frozen at length 0) and paged
  ``prefill_chunk`` (a prompt in two chunks beside a frozen row): logits
  and every leaf at ``1e-5``.
- The engine on the mix that a window-covering hybrid used to reject
  (``tests/test_torch_engine_edges.py``'s mix plus a 40-token prompt;
  ``n_slots=2``, ``page_size=4``, ``n_pages=12``, whole-prompt and chunk
  4): statuses, greedy streams and ``page_stats()`` equal to the JAX
  engine's, and the prompt of ``max_len`` with budget 4, the 6-token
  prompt with budget 34 and the 40-token prompt end ``OK``. A 40-token
  prompt passes the window of 32: the reference applies the window only in
  whole-prompt prefill, and the port copies that (ROADMAP.md, "reference
  behaviours").
- An ``alloc`` fault plan on the paged hybrid: the same statuses, streams
  and firing log as the JAX engine under the same plan.
- ``snapshot_engine`` / ``restore_engine`` of a paged hybrid engine caught
  mid-run, through JSON: every request bit-equal to the uninterrupted run.
- ``prefix_cache`` is refused for the hybrid with the reference's error.
"""
import json

import jax
import jax.numpy as jnp
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
from repro_torch.models import get_model, init_params
from repro_torch.serve import OK, FaultPlan, SamplingParams, ServeEngine

WINDOWS = {"window 0": 0, "window 32": 32}
MAX_LEN = 24
PAGED = {"max_len": MAX_LEN, "n_slots": 2, "page_size": 4, "n_pages": 12}
SSM_KEYS = {"ssm_h", "conv_x", "conv_bc"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=list(WINDOWS))
def carried(request):
    w = WINDOWS[request.param]
    jcfg = jsmoke("hymba_15b").replace(attn_impl="xla", window=w)
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config("hymba_15b").replace(window=w)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


def _close(got: dict, want: dict, msg: str, tol: float = 1e-5):
    assert set(got) == set(want), msg
    for key, val in got.items():
        g, w = val.numpy(), np.asarray(want[key])
        assert g.shape == w.shape, f"{msg} {key}"
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=tol, rtol=0, err_msg=f"{msg} {key}")


# ---------------------------------------------------------------------------
# The paged cache's entries against the reference's
# ---------------------------------------------------------------------------

def test_init_paged_cache_matches_reference(carried):
    jmodel, _, model, _ = carried
    got = model.init_paged_cache(3, 10, 4, 6, device="cpu")
    want = jmodel.init_paged_cache(3, 10, 4, 6)
    assert set(got) == set(want) >= SSM_KEYS | {"pages_k", "pages_v",
                                                "pages_phi", "page_table"}
    for key, val in got.items():
        assert tuple(val.shape) == want[key].shape, key
        assert str(val.dtype).split(".")[-1] == str(want[key].dtype), key
        assert not val.any(), key


def _wave(model, vocab):
    """A 3-row wave right-padded to 8 (a page multiple): rows of 8, 3 and 5
    tokens; the third row is padding that the insert drops."""
    rng = np.random.RandomState(2)
    toks = rng.randint(0, vocab, (3, 8)).astype(np.int32)
    lens = np.array([8, 3, 5], np.int32)
    slots = np.array([1, 0, 2], np.int32)          # slot 2 is out of range
    tables = np.array([[3, 7, 12, 12, 12, 12], [5, 12, 12, 12, 12, 12],
                       [0, 1, 12, 12, 12, 12]], np.int32)
    return toks, lens, slots, tables


def _inserted(carried):
    """Both packages' paged caches after inserting ``_wave``; returns
    (port cache, reference cache)."""
    jmodel, jparams, model, params = carried
    toks, lens, slots, tables = _wave(model, model.cfg.vocab)
    with torch.no_grad():
        _, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              max_len=8, lengths=torch.from_numpy(lens))
        got = model.insert_paged(model.init_paged_cache(
            2, 12, 4, 6, device="cpu"), tc, slots, tables)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=8,
                           lengths=jnp.asarray(lens))
    want = jmodel.insert_paged(jmodel.init_paged_cache(2, 12, 4, 6), jc,
                               jnp.asarray(slots), jnp.asarray(tables))
    return got, want


def test_insert_and_grow_match_reference(carried):
    jmodel, _, model, _ = carried
    got, want = _inserted(carried)
    _close(got, want, "insert")
    assert got["length"].tolist() == [3, 8]
    assert got["ssm_h"][:, 0].any() and got["ssm_h"][:, 1].any()
    slots = np.array([0, 2], np.int32)
    tables = np.array([[5, 9, 12, 12, 12, 12], [4, 4, 4, 4, 4, 4]], np.int32)
    got = model.grow_page_table(got, slots, tables)
    want = jmodel.grow_page_table(want, jnp.asarray(slots),
                                  jnp.asarray(tables))
    _close(got, want, "grow")
    assert got["page_table"][0, :2].tolist() == [5, 9]


def test_paged_decode_steps_match_reference(carried):
    """Three steps of both slots, then three with slot 0 frozen at length
    0: the SSM state and the pools move only for the live slot."""
    jmodel, jparams, model, params = carried
    cache, jcache = _inserted(carried)
    # slot 1 (length 8) grows into pages 8 and 9; slot 0 keeps one page
    slots = np.array([1], np.int32)
    tables = np.array([[3, 7, 8, 9, 12, 12]], np.int32)
    cache = model.grow_page_table(cache, slots, tables)
    jcache = jmodel.grow_page_table(jcache, jnp.asarray(slots),
                                    jnp.asarray(tables))
    rng = np.random.RandomState(4)
    for step in range(6):
        if step == 3:
            cache["length"][0] = 0
            jcache = {**jcache, "length": jcache["length"].at[0].set(0)}
            frozen = {k: cache[k][:, 0].clone() for k in SSM_KEYS}
        toks = rng.randint(0, model.cfg.vocab, (2, 1)).astype(np.int32)
        with torch.no_grad():
            logits, cache = model.decode(params, cache, torch.from_numpy(toks),
                                         max_pages=4)
        jlogits, jcache = jmodel.decode(jparams, jcache, jnp.asarray(toks),
                                        max_pages=4)
        live = slice(1, 2) if step >= 3 else slice(0, 2)
        np.testing.assert_allclose(logits.numpy()[live],
                                   np.asarray(jlogits)[live], atol=1e-5,
                                   rtol=0, err_msg=f"step {step}")
        _close(cache, jcache, f"step {step}")
    for key, val in frozen.items():
        assert torch.equal(cache[key][:, 0], val), key
    assert cache["length"].tolist() == [0, 14]


def test_paged_prefill_chunk_matches_reference(carried):
    """A 7-token prompt in two 4-token chunks on slot 0 (its first chunk
    over slot 0's old SSM state, which it must not read), slot 1 frozen,
    then a decode step: logits and every leaf at 1e-5."""
    jmodel, jparams, model, params = carried
    cache, jcache = _inserted(carried)
    tables = np.array([[2, 6, 12, 12, 12, 12]], np.int32)
    cache = model.grow_page_table(cache, np.array([0]), tables)
    jcache = jmodel.grow_page_table(jcache, jnp.asarray([0]),
                                    jnp.asarray(tables))
    cache["length"][0] = 0
    jcache = {**jcache, "length": jcache["length"].at[0].set(0)}
    prompt = np.random.RandomState(6).randint(0, model.cfg.vocab, (7,))
    for off, final in ((0, -1), (4, 7)):
        n = min(4, 7 - off)
        toks = np.zeros((2, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        kw = dict(offsets=np.array([off, 0]), chunk_lens=np.array([n, 0]),
                  final_lens=np.array([final, -1]))
        with torch.no_grad():
            logits, cache = model.prefill_chunk(
                params, cache, torch.from_numpy(toks), **kw)
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcache, jnp.asarray(toks),
            **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()})
        np.testing.assert_allclose(logits.numpy()[0], np.asarray(jlogits)[0],
                                   atol=1e-5, rtol=0)
        _close(cache, jcache, f"chunk at {off}")
    assert cache["length"].tolist() == [7, 8]
    toks = np.array([[3], [5]], np.int32)
    with torch.no_grad():
        logits, cache = model.decode(params, cache, torch.from_numpy(toks))
    jlogits, jcache = jmodel.decode(jparams, jcache, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    _close(cache, jcache, "decode after the chunks")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _mix(vocab):
    """``tests/test_torch_engine_edges.py``'s mix and a 40-token prompt."""
    rng = np.random.RandomState(3)

    def prompt(n):
        return rng.randint(0, vocab, (n,)).astype(np.int32)

    return [(prompt(9), 6), (prompt(5), 7), (prompt(MAX_LEN), 4),
            (prompt(0), 3), (prompt(7), 0), (prompt(6), MAX_LEN + 10),
            (prompt(3), 5), (prompt(11), 4), (prompt(40), 4)]


# the requests a window-covering hybrid rejected while it did not page
FORMERLY_REJECTED = (2, 5, 8)


def _drive(eng, mix):
    rids = []
    for i, (p, b) in enumerate(mix):
        rids.append(eng.submit(p, b, strict=False))
        if i == 1:
            eng.step()
            eng.step()
    eng.run()
    return [(eng.result(r).status, np.asarray(eng.result(r)).tolist())
            for r in rids]


@pytest.mark.parametrize("chunk", [None, 4], ids=["whole", "chunk4"])
def test_engine_matches_reference_on_the_rejected_mix(carried, chunk):
    jmodel, jparams, model, params = carried
    mix = _mix(model.cfg.vocab)
    kw = dict(PAGED, prefill_chunk=chunk)
    jeng = JServeEngine(jmodel, jparams, **kw)
    eng = ServeEngine(model, params, device="cpu", **kw)
    assert eng.backend.paged and jeng.backend.paged
    want, got = _drive(jeng, mix), _drive(eng, mix)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {i}: {g} != {w}"
    for i in FORMERLY_REJECTED:
        assert got[i][0] == OK and len(got[i][1]) == mix[i][1], i
    assert eng.page_stats() == jeng.page_stats()
    assert eng.backend._pool.n_free == eng.n_pages


def test_alloc_faults_match_reference(carried):
    jmodel, jparams, model, params = carried
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, model.cfg.vocab, (n,)).astype(np.int32)
               for n in (6, 7, 5)]
    plan = "alloc@2x3,alloc@9"
    out = {}
    for name, eng in (
            ("port", ServeEngine(model, params, device="cpu",
                                 faults=FaultPlan.parse(plan), **PAGED)),
            ("reference", JServeEngine(jmodel, jparams,
                                       faults=JFaultPlan.parse(plan),
                                       **PAGED))):
        rids = [eng.submit(p, 12, max_retries=1) for p in prompts]
        eng.run()
        recs = [eng.result(r) for r in rids]
        out[name] = ([r.status for r in recs],
                     [np.asarray(r).tolist() for r in recs],
                     list(eng.faults.fired), eng.n_preemptions)
    assert out["port"] == out["reference"]
    assert out["port"][2]                             # the plan fired


def test_snapshot_restore_round_trip(carried):
    _, _, model, params = carried
    prompts = [np.random.RandomState(9).randint(
        0, model.cfg.vocab, (n,)).astype(np.int32) for n in (9, 5, 12, 7)]

    def make():
        return ServeEngine(model, params, device="cpu", prefill_chunk=4,
                           **PAGED)

    def submit(eng):
        return [eng.submit(p, 8, sampling=SamplingParams(float(i % 2), 0,
                                                         seed=i))
                for i, p in enumerate(prompts)]

    ref = make()
    rids = submit(ref)
    ref.run()
    want = [np.asarray(ref.result(r)) for r in rids]
    src = make()
    assert submit(src) == rids
    for _ in range(4):
        src.step()
    state = json.loads(json.dumps(src.snapshot_engine()))
    assert state["live"]
    dst = make()
    dst.restore_engine(state)
    dst.run()
    src.run()
    for rid, w in zip(rids, want):
        assert dst.result(rid).status == OK
        np.testing.assert_array_equal(dst.result(rid), w)
        np.testing.assert_array_equal(src.result(rid), w)
    assert dst.backend._pool.n_free == dst.n_pages


def test_prefix_cache_is_refused(carried):
    jmodel, jparams, model, params = carried
    kw = dict(PAGED, prefill_chunk=4, prefix_cache=True)
    with pytest.raises(ValueError, match="recurrent state"):
        JServeEngine(jmodel, jparams, **kw)
    with pytest.raises(ValueError, match="recurrent state"):
        ServeEngine(model, params, device="cpu", **kw)


def test_window_beyond_max_len_keeps_the_ring():
    """A window shorter than max_len keeps the ring and ignores page_size,
    as before (the paged entries exist, the backend does not use them)."""
    cfg = smoke_config("hymba_15b")
    model = get_model(cfg)
    assert model.init_paged_cache is not None and model.copy_pages is None
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, device="cpu", max_len=48, n_slots=2,
                      page_size=4)
    assert eng.backend.ring and not eng.backend.paged

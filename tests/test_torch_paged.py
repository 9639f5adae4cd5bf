"""The port's paged KV serving against the JAX reference, on the CPU.

- ``PagePool``: the reference's allocator unit tests, as cases of one test.
- ``ops.flash_decode(page_table=...)``: the port's plain paged path against
  the reference's Pallas paged kernel in interpret mode (none / phi /
  alibi; shared and per-kv-head factor slabs; GQA; permuted and wide
  garbage page tables), active rows at ``atol 3e-5`` in float32.
- ``init_paged_cache`` + ``insert_paged_cache_at_slots`` + ``decode_step``
  against the reference's on both smoke configs: logits and pools at
  float32.
- The paged engine: greedy streams equal to the reference's paged engine
  and to the port's contiguous engine on a staggered schedule; requests
  preempted when the pool runs dry equal the same requests run alone, bit
  for bit; ``page_stats()`` equal to the reference's; a drained engine has
  every page free.

Inputs come from numpy seeds; the reference's parameters are carried across
with ``params_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.serve import PagePool as JPagePool
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_decode import (
    flash_decode_paged_fwd,
    flash_decode_paged_torch,
)
from repro_torch.models import get_model
from repro_torch.serve import (
    OK,
    AdmissionRejected,
    PagePool,
    PoolError,
    SamplingParams,
    ServeEngine,
)

ARCHS = ["gpt2_alibi_15b", "stablelm_12b"]


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


# ---------------------------------------------------------------------------
# PagePool (the cases of tests/test_paged_serve.py and test_lazy_pages.py)
# ---------------------------------------------------------------------------

def _pool_alloc_free_accounting(cls):
    pool = cls(8, 4)
    assert pool.n_free == 8
    a = pool.alloc(3)
    assert sorted(a) == [0, 1, 2] and pool.n_free == 5
    b = pool.alloc(2)
    assert sorted(b) == [3, 4] and pool.n_free == 3
    pool.free(a)
    assert pool.n_free == 6


def _pool_fragmented_reuses_lowest_first(cls):
    pool = cls(6, 4)
    a, b, c = pool.alloc(2), pool.alloc(2), pool.alloc(2)
    pool.free(a)
    pool.free(c)
    got = pool.alloc(3)
    assert got == [0, 1, 4] and pool.n_free == 1
    pool.free(got + b)
    assert pool.n_free == 6


def _pool_oom_raises_and_can_alloc_gates(cls):
    pool = cls(4, 16)
    pool.alloc(3)
    assert pool.can_alloc(1) and not pool.can_alloc(2)
    with pytest.raises(MemoryError):
        pool.alloc(2)
    assert pool.n_free == 1


def _pool_double_free_and_refcount(cls):
    pool = cls(4, 8)
    a = pool.alloc(2)
    pool.incref(a[:1])
    assert pool.refcount(a[0]) == 2 and pool.free(a) == [a[1]]
    assert pool.free(a[:1]) == [a[0]]
    with pytest.raises(Exception, match="double free"):
        pool.free(a)
    with pytest.raises(Exception, match="incref of free page"):
        pool.incref(a)
    with pytest.raises(Exception, match="outside pool"):
        pool.refcount(4)


def _pool_pages_needed(cls):
    pool = cls(8, 16)
    assert [pool.pages_needed(n) for n in (1, 16, 17, 0)] == [1, 1, 2, 1]


def _pool_grow_is_alloc_with_separate_accounting(cls):
    pool = cls(6, 8)
    a = pool.alloc(2)
    g = pool.grow(1)
    assert a == [0, 1] and g == [2]
    assert pool.n_used == 3 and pool.n_grown == 1
    with pytest.raises(MemoryError):
        pool.grow(4)
    assert pool.n_grown == 1


def _pool_watermark_tracks_peak(cls):
    pool = cls(8, 4)
    a = pool.alloc(3)
    assert pool.watermark == 3
    b = pool.grow(2)
    assert pool.watermark == 5
    pool.free(a + b)
    assert pool.n_used == 0 and pool.watermark == 5
    pool.alloc(2)
    assert pool.watermark == 5


def _pool_freed_reused_lowest_first_after_growth(cls):
    pool = cls(6, 4)
    a = pool.alloc(2)
    pool.alloc(2)
    pool.free(a)
    assert pool.grow(3) == [0, 1, 4]


POOL_CASES = [_pool_alloc_free_accounting,
              _pool_fragmented_reuses_lowest_first,
              _pool_oom_raises_and_can_alloc_gates,
              _pool_double_free_and_refcount, _pool_pages_needed,
              _pool_grow_is_alloc_with_separate_accounting,
              _pool_watermark_tracks_peak,
              _pool_freed_reused_lowest_first_after_growth]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[c.__name__[6:] for c in POOL_CASES])
def test_page_pool_matches_reference(case):
    case(PagePool)
    case(JPagePool)          # the same contract holds for the reference


def test_page_pool_errors_are_typed():
    pool = PagePool(2, 4)
    with pytest.raises(PoolError):
        pool.free([0])
    with pytest.raises(ValueError):
        PagePool(0, 4)


# ---------------------------------------------------------------------------
# ops.flash_decode(page_table=...) against the reference's paged kernel
# ---------------------------------------------------------------------------

B, KVH, D, PS, R = 3, 2, 16, 8, 3
LENGTHS = np.array([17, 0, 40], np.int32)         # ragged, one idle row
P_LIVE = 5                                         # ceil(40 / 8)


def _paged_case(rng, heads, mode, table):
    n_pages = B * P_LIVE + 4
    q = rng.standard_normal((B, 1, heads, D)).astype(np.float32)
    kp = rng.standard_normal((KVH, n_pages, PS, D)).astype(np.float32)
    vp = rng.standard_normal((KVH, n_pages, PS, D)).astype(np.float32)
    pt = rng.permutation(n_pages)[:B * P_LIVE].reshape(B, P_LIVE)
    if table == "garbage":       # a wide table whose tail is stale junk
        junk = rng.integers(-3, 2 * n_pages, (B, 6))
        pt = np.concatenate([pt, junk], 1)
        pt[0, 3:P_LIVE] = n_pages + 7     # unmapped: past row 0's length
    kw = {}
    if mode == "alibi":
        kw["slopes"] = (0.5 ** np.arange(1, heads + 1)).astype(np.float32)
    elif mode.startswith("phi"):
        kw["phi_q"] = rng.standard_normal((B, 1, heads, R)).astype(np.float32)
        lead = (KVH,) if mode == "phi_kvh" else ()
        kw["phi_k"] = rng.standard_normal(
            lead + (n_pages, PS, R)).astype(np.float32)
    return q, kp, vp, pt.astype(np.int32), kw


@pytest.mark.parametrize("table", ["permuted", "garbage"])
@pytest.mark.parametrize("mode", ["none", "alibi", "phi_shared", "phi_kvh"])
@pytest.mark.parametrize("heads", [8, 2], ids=["gqa", "mha"])
def test_paged_decode_matches_reference_kernel(heads, mode, table):
    rng = np.random.default_rng(11)
    q, kp, vp, pt, kw = _paged_case(rng, heads, mode, table)
    want = jops.flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(LENGTHS), page_table=jnp.asarray(pt), kv_layout="bhsd",
        impl="pallas_interpret", **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(kp),
                            torch.from_numpy(vp), torch.from_numpy(LENGTHS),
                            page_table=torch.from_numpy(pt), impl="torch",
                            **tkw)
    live = LENGTHS > 0
    np.testing.assert_allclose(got.numpy()[live],
                               np.asarray(want, np.float32)[live], atol=3e-5)
    assert not got[~torch.from_numpy(live)].any()     # idle rows give 0
    capped = tops.flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(LENGTHS), page_table=torch.from_numpy(pt),
        impl="auto", max_pages=P_LIVE, **tkw)
    torch.testing.assert_close(capped, got, rtol=0, atol=1e-6)


def test_paged_shared_phi_q_repeats_over_the_group():
    """A phi_q with one row per kv head is shared by its group's q heads."""
    rng = np.random.default_rng(12)
    q, kp, vp, pt, kw = _paged_case(rng, 8, "phi_shared", "permuted")
    pq_kv = torch.from_numpy(kw["phi_q"][:, :, :KVH])
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(LENGTHS))
    slab = torch.from_numpy(kw["phi_k"])
    got = tops.flash_decode(*args, phi_q=pq_kv, phi_k=slab,
                            page_table=torch.from_numpy(pt))
    want = tops.flash_decode(*args, phi_q=pq_kv.repeat_interleave(4, dim=2),
                             phi_k=slab, page_table=torch.from_numpy(pt))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paged_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(13)
    q, kp, vp, pt, kw = _paged_case(rng, 2, "phi_kvh", "garbage")
    qg = torch.from_numpy(q)[:, 0].reshape(B, KVH, 1, D)
    pq = torch.from_numpy(kw["phi_q"])[:, 0].reshape(B, KVH, 1, R)
    args = (qg, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(LENGTHS), torch.from_numpy(pt), pq,
            torch.from_numpy(kw["phi_k"]))
    before = flash_decode_paged_fwd.launches
    torch.testing.assert_close(flash_decode_paged_fwd(*args, scale=0.25),
                               flash_decode_paged_torch(*args, scale=0.25),
                               rtol=0, atol=0)
    assert flash_decode_paged_fwd.launches == before


# ---------------------------------------------------------------------------
# The LM's paged cache against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_reference(arch):
    jmodel, jparams, model, params = _carried(arch)
    jcfg = jmodel.cfg
    cfg = model.cfg
    n_slots, n_pages, ps, pps = 3, 14, 4, 6
    lengths = np.array([9, 5, 1], np.int32)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (n_slots, 12)).astype(np.int32)
    tables = np.full((n_slots, pps), n_pages, np.int32)
    tables[0, :4] = [11, 2, 7, 4]       # prompt (3 pages) + one reserved
    tables[1, :2] = [0, 13]
    tables[2, :1] = [5]
    slots = np.array([2, 0, 3])         # row 2 is a padding row: dropped
    jl, jwave = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            max_len=12, lengths=jnp.asarray(lengths))
    jc = jlm.init_paged_cache(jcfg, n_slots, n_pages, ps, pps)
    jc = jlm.insert_paged_cache_at_slots(jc, jwave, slots, tables)
    with torch.no_grad():
        tl, twave = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  max_len=12,
                                  lengths=torch.from_numpy(lengths))
        tc = model.init_paged_cache(n_slots, n_pages, ps, pps, device="cpu")
        tc = model.insert_paged(tc, twave, slots, tables)
    for key in ("pages_k", "pages_v", "pages_phi", "page_table", "length"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    tok = rng.integers(0, cfg.vocab, (n_slots, 1)).astype(np.int32)
    for step in range(5):
        if step == 3:                   # slot 0 grows its third page
            grow = np.full((2, pps), n_pages, np.int32)
            grow[0, :3] = [0, 13, 9]
            slots_g = np.array([0, n_slots])    # a dropped padding row
            jc = jlm.grow_page_tables_at_slots(jc, slots_g, grow)
            tc = model.grow_page_table(tc, slots_g, grow)
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(tok), jcfg,
                                 max_pages=4)
        with torch.no_grad():
            tl, tc = model.decode(params, tc, torch.from_numpy(tok).long(),
                                  max_pages=4)
        # slot 1 is idle (length 0): the reference's XLA path returns the
        # cache mean there and the port 0, so active rows are compared
        np.testing.assert_allclose(tl.numpy()[[0, 2]],
                                   np.asarray(jl, np.float32)[[0, 2]],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch} step {step}")
        tok = np.asarray(jl)[:, 0, :cfg.vocab].argmax(-1)[:, None]
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    for key in ("pages_k", "pages_v", "pages_phi"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_frozen_rows_never_write():
    """An idle lane whose stale table points at pages now owned by another
    row writes nothing, and a live row whose table entry is the sentinel
    drops its write, as the reference's out-of-range scatter does."""
    _, _, model, params = _carried("gpt2_alibi_15b")
    n_pages, ps = 6, 4
    cache = model.init_paged_cache(3, n_pages, ps, 2, device="cpu")
    cache["length"][:] = torch.tensor([4, 0, 8], dtype=torch.int32)
    cache["page_table"][:] = torch.tensor([[1, 2], [1, 2], [3, n_pages]],
                                          dtype=torch.int32)
    before = {k: cache[k].clone() for k in ("pages_k", "pages_phi")}
    with torch.no_grad():
        _, cache = model.decode(params, cache, torch.ones((3, 1),
                                                          dtype=torch.long))
    changed = (cache["pages_k"] != before["pages_k"]).any(-1).nonzero()
    assert {(int(p), int(o)) for p, o in changed[:, 2:].tolist()} == {(2, 0)}
    assert (cache["pages_phi"] != before["pages_phi"]).any(-1).nonzero() \
        .tolist() == [[2, 0]]
    assert cache["pages_phi"][2, 0].tolist() == [1.0, 4.0]
    assert cache["length"].tolist() == [5, 0, 9]


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------

def _stagger(eng, prompts, budgets, samplings=None):
    samplings = samplings or [None] * len(prompts)
    rids = [eng.submit(prompts[0], budgets[0], sampling=samplings[0]),
            eng.submit(prompts[1], budgets[1], sampling=samplings[1])]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], budgets[2], sampling=samplings[2]))
    eng.run()
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_reference_and_contiguous(arch):
    """The staggered schedule of tests/test_paged_serve.py: the port's paged
    engine gives the reference's paged engine's greedy streams and its own
    contiguous engine's, and ends with every page free."""
    jmodel, jparams, model, params = _carried(arch)
    kw = {"max_len": 48, "n_slots": 2, "prefill_len": 11}
    prompts = _prompts(model.cfg.vocab, (4, 11, 7), seed=2)
    budgets = [7, 4, 6]
    want = _stagger(JServeEngine(jmodel, jparams, page_size=16, **kw),
                    prompts, budgets)
    contiguous = _stagger(ServeEngine(model, params, device="cpu", **kw),
                          prompts, budgets)
    eng = ServeEngine(model, params, device="cpu", page_size=16, **kw)
    got = _stagger(eng, prompts, budgets)
    for i, (g, w, c) in enumerate(zip(got, want, contiguous)):
        assert g.status == OK and g.size == budgets[i]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")
        np.testing.assert_array_equal(g, c, err_msg=f"req {i}")
    assert eng.backend._pool.n_free == eng.n_pages == 6


PRESSURE = {"max_len": 32, "n_slots": 2, "prefill_len": 10, "page_size": 8,
            "n_pages": 3}


def _alone(model, params, prompt, budget, sampling=None):
    eng = ServeEngine(model, params, device="cpu", **PRESSURE)
    rid = eng.submit(prompt, budget, sampling=sampling)
    eng.run()
    return eng.result(rid)


def test_preempted_equals_alone_and_page_stats_match_reference(stablelm):
    """tests/test_lazy_pages.py's pool-exhaustion schedule: the engine
    preempts on its own when growth finds a 3-page pool dry. Every request,
    the sampled one included, equals its alone run bit for bit; greedy
    streams and ``page_stats()`` equal the reference's; the drained pool is
    whole."""
    jmodel, jparams, model, params = stablelm
    prompts = _prompts(model.cfg.vocab, (7, 9, 5), seed=6)
    budgets = [6, 6, 8]
    samplings = [None, None, SamplingParams(temperature=0.7, top_k=5,
                                            seed=42)]

    def drive(eng):
        rids = [eng.submit(prompts[0], budgets[0]),
                eng.submit(prompts[1], budgets[1])]
        eng.step()
        rids.append(eng.submit(prompts[2], budgets[2],
                               sampling=samplings[2]))
        eng.run()
        return [eng.result(r) for r in rids]

    jeng = JServeEngine(jmodel, jparams, **PRESSURE)
    want = drive(jeng)
    eng = ServeEngine(model, params, device="cpu", **PRESSURE)
    got = drive(eng)
    assert eng.n_preemptions >= 1
    assert eng.page_stats() == jeng.page_stats()
    assert eng.page_stats()["grown"] >= 1
    for i, (g, p, b, sp) in enumerate(zip(got, prompts, budgets, samplings)):
        assert g.status == OK and g.size == b
        np.testing.assert_array_equal(g, _alone(model, params, p, b, sp),
                                      err_msg=f"req {i}")
        if sp is None:
            np.testing.assert_array_equal(g, np.asarray(want[i]),
                                          err_msg=f"req {i}")
    assert eng.backend._pool.n_free == eng.n_pages


def test_preemption_frees_pages_for_lowest_index_reuse(stablelm):
    _, _, model, params = stablelm
    eng = ServeEngine(model, params, device="cpu", **PRESSURE)
    p0, p1 = _prompts(model.cfg.vocab, (7, 9), seed=6)
    r0, r1 = eng.submit(p0, 6), eng.submit(p1, 6)
    eng.step()                             # admit both: 1 + 2 pages, dry
    assert eng.backend._slot_pages == {0: [0], 1: [1, 2]}
    eng.step()                             # r0 crosses 8: grow -> preempt r1
    assert eng.n_preemptions == 1 and not eng.is_done(r1)
    assert eng.backend._slot_pages == {0: [0, 1]}
    eng.run()
    for rid, p in ((r0, p0), (r1, p1)):
        np.testing.assert_array_equal(eng.result(rid),
                                      _alone(model, params, p, 6))
    assert eng.backend._pool.n_free == eng.n_pages


def test_whole_reservation_never_grows_and_lazy_grows_on_boundaries(
        stablelm):
    _, _, model, params = stablelm
    kw = {"max_len": 32, "n_slots": 2, "prefill_len": 10, "page_size": 8}
    prompts = _prompts(model.cfg.vocab, (7, 9), seed=2)
    whole = ServeEngine(model, params, device="cpu",
                        page_reservation="whole", **kw)
    out_whole = whole.generate(prompts, 8)
    assert whole.page_stats()["grown"] == 0
    assert whole.page_stats()["preemptions"] == 0
    lazy = ServeEngine(model, params, device="cpu", **kw)
    np.testing.assert_array_equal(out_whole, lazy.generate(prompts, 8))
    # 7 + 8 - 1 = 14 and 9 + 8 - 1 = 16 positions: two pages each, the
    # second grown as the length crosses 8
    assert lazy.page_stats()["grown"] == 1
    assert lazy.page_stats()["watermark"] == 4
    assert lazy.backend._pool.n_free == lazy.n_pages


def test_paged_validation_lifts_max_len_and_bounds_the_footprint(stablelm):
    _, _, model, params = stablelm
    eng = ServeEngine(model, params, device="cpu", max_len=16, n_slots=2,
                      prefill_len=10, page_size=4, pages_per_slot=6)
    prompt = _prompts(model.cfg.vocab, (9,))[0]
    rid = eng.submit(prompt, 14)     # 9 + 14 > max_len: fine when paged
    with pytest.raises(AdmissionRejected, match="paged mode.*page-table"):
        eng.submit(prompt, 17)       # ceil((9 + 17 - 1) / 4) = 7 > 6 rows
    eng.run()
    assert eng.result(rid).status == OK and eng.result(rid).size == 14
    with pytest.raises(ValueError, match="page_reservation"):
        ServeEngine(model, params, device="cpu", page_size=4,
                    page_reservation="eager")

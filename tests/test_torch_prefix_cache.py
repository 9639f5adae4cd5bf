"""The port's prefix caching against the JAX reference, on the CPU (the
counterpart of ``tests/test_prefix_cache.py``).

- ``PagePool`` refcounts: free is a decref, a page drains at zero, double
  free and incref of a free page are refused (port and reference alike).
- ``PrefixCache``: full-block match and insert, the block compare that
  rejects a hash collision, LRU leaf-first eviction, and the evictable
  count that leaves out chains pinned by a live sharer, each run on the
  port's index and the reference's with the same outcome.
- ``lm.copy_paged_pages`` against the reference's on every paged leaf.
- The engine: retirement keeps the prompt's full pages in the index; a
  second request hits and emits identically; a page-aligned hit copies on
  write; shared streams bit-equal to the unshared engine's, greedy and
  sampled, also through preemption of a request that shares pages under a
  tight pool; the submit error states the shared pages; matched-token
  counts, streams and statuses equal to the JAX engine's.
- The MoE case (``granite_moe_3b_a800m``, sampled: expert routing and the
  sampling streams): shared streams bit-equal to the unshared engine's
  with a hit rate above 0, as the reference's
  ``test_shared_vs_unshared_bit_parity`` holds it; greedy streams,
  statuses and the prefix counters equal to the JAX prefix engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import ServeEngine as JServeEngine
from repro.serve.pages import PagePool as JPagePool
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import (
    OK,
    AdmissionRejected,
    PagePool,
    PoolError,
    SamplingParams,
    ServeEngine,
)
from repro_torch.serve.prefix import PrefixCache

IMPLS = {"port": (PagePool, PrefixCache), "reference": (JPagePool,
                                                        JPrefixCache)}


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


def _shared_prompts(vocab, common_len, tails, seed=11):
    rng = np.random.RandomState(seed)
    common = rng.randint(0, vocab, (common_len,)).astype(np.int32)
    return [np.concatenate([common, rng.randint(
        0, vocab, (n,)).astype(np.int32)]) for n in tails]


def _run(model, params, prompts, *, prefix_cache, n_pages=None, budget=14,
         temp=0.0, n_slots=2):
    kw = {} if n_pages is None else {"n_pages": n_pages}
    eng = ServeEngine(model, params, max_len=64, n_slots=n_slots,
                      page_size=4, pages_per_slot=16, prefill_chunk=4,
                      prefix_cache=prefix_cache, device="cpu", **kw)
    rids = [eng.submit(p, budget, sampling=SamplingParams(temp, 0, seed=i))
            for i, p in enumerate(prompts)]
    eng.run()
    return [eng.result(r) for r in rids], eng


# ---------------------------------------------------------------------------
# PagePool refcounts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(IMPLS))
def test_pool_refcount_units(impl):
    pool = IMPLS[impl][0](4, page_size=4)
    a, b = pool.alloc(2)
    assert pool.refcount(a) == 1 and pool.refcount(b) == 1
    pool.incref([a])
    assert pool.refcount(a) == 2
    assert pool.free([a]) == []            # decref: still one holder
    assert pool.n_free == 2
    assert pool.free([a, b]) == [a, b]     # last holders: both drain
    assert pool.n_free == 4


def test_pool_double_free_and_incref_of_free_refused():
    pool = PagePool(2, page_size=4)
    (p,) = pool.alloc(1)
    pool.free([p])
    with pytest.raises(PoolError, match="double free"):
        pool.free([p])
    with pytest.raises(PoolError, match="incref of free"):
        pool.incref([1])


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(IMPLS))
def test_index_match_walks_full_blocks_only(impl):
    pool_cls, index_cls = IMPLS[impl]
    pool, idx = pool_cls(8, page_size=4), index_cls(4)
    toks = np.arange(10, dtype=np.int32)        # 2 full blocks + partial
    pages = pool.alloc(3)
    assert idx.insert(toks, pages, pool) == 2   # partial page never indexed
    assert idx.match(toks) == (pages[:2], 8)
    other = np.concatenate([toks[:4], toks[4:8][::-1]])
    assert idx.match(other) == (pages[:1], 4)
    assert pool.refcount(pages[0]) == 2         # request + index
    assert pool.refcount(pages[2]) == 1         # partial page: request only


@pytest.mark.parametrize("impl", list(IMPLS))
def test_index_rejects_hash_collisions_by_block_compare(impl):
    pool_cls, index_cls = IMPLS[impl]
    pool = pool_cls(8, page_size=4)
    idx = index_cls(4, digest=lambda parent, block: b"collide")
    toks_a = np.arange(4, dtype=np.int32)
    idx.insert(toks_a, pool.alloc(1), pool)
    assert idx.match(np.arange(4, 8, dtype=np.int32)) == ([], 0)
    assert idx.n_rejected == 1
    assert idx.match(toks_a)[1] == 4


@pytest.mark.parametrize("impl", list(IMPLS))
def test_index_eviction_is_lru_leaf_first(impl):
    pool_cls, index_cls = IMPLS[impl]
    pool, idx = pool_cls(8, page_size=2), index_cls(2)
    toks = np.arange(6, dtype=np.int32)         # a chain of 3 entries
    pages = pool.alloc(3)
    idx.insert(toks, pages, pool)
    pool.free(pages)                            # the request retires
    assert idx.n_evictable(pool) == 3
    assert idx.evict(pool, 1) == 1              # the deepest leaf first
    assert idx.match(toks) == (pages[:2], 4)
    assert idx.evict(pool, 5) == 2              # drains the rest, stops dry
    assert (len(idx), pool.n_free, idx.n_evicted) == (0, 8, 3)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_index_evictable_excludes_chains_pinned_by_live_sharers(impl):
    pool_cls, index_cls = IMPLS[impl]
    pool, idx = pool_cls(8, page_size=2), index_cls(2)
    toks = np.arange(6, dtype=np.int32)
    pages = pool.alloc(3)
    idx.insert(toks, pages, pool)
    pool.free(pages[:2])                        # ancestors: index-only
    assert pool.refcount(pages[2]) == 2         # the leaf still shared
    assert idx.n_cached(pool) == 2
    assert idx.n_evictable(pool) == 0           # pinned behind the leaf
    assert idx.evict(pool, 2) == 0
    pool.free([pages[2]])                       # the sharer retires
    assert idx.n_evictable(pool) == 3


# ---------------------------------------------------------------------------
# copy_paged_pages
# ---------------------------------------------------------------------------

def test_copy_paged_pages_matches_reference():
    cfg, jcfg = smoke_config("gpt2_alibi_15b"), jsmoke(
        "gpt2_alibi_15b").replace(attn_impl="xla")
    rng = np.random.default_rng(0)
    n_pages, ps = 12, 4
    jcache = jlm.init_paged_cache(jcfg, 2, n_pages, ps, 6)
    cache = get_model(cfg).init_paged_cache(2, n_pages, ps, 6, device="cpu")
    for key in ("pages_k", "pages_v", "pages_phi"):
        val = rng.standard_normal(cache[key].shape).astype(np.float32)
        cache[key][:] = torch.tensor(val)
        jcache[key] = jnp.asarray(val)
    # 3 -> 5 and 5 -> 7 in one batch (reads the pool before the copy), a
    # dropped entry (dst out of range)
    src, dst = np.array([3, 5, 1]), np.array([5, 7, n_pages])
    want = jlm.copy_paged_pages(jcache, src, dst)
    got = get_model(cfg).copy_pages(cache, src, dst)
    for key in ("pages_k", "pages_v", "pages_phi"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert torch.equal(got["pages_k"][:, :, 7], torch.tensor(
        np.asarray(jcache["pages_k"])[:, :, 5]))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_retire_retains_prompt_pages_in_index(stablelm):
    _, _, model, params = stablelm
    prompts = _shared_prompts(model.cfg.vocab, 8, (2,))
    _, eng = _run(model, params, prompts, prefix_cache=True, budget=6)
    be, pool = eng.backend, eng.backend._pool
    assert len(be._prefix) == 2                 # full prompt pages indexed
    assert be._prefix.n_cached(pool) == 2       # kept past retirement
    assert pool.n_free == eng.n_pages - 2
    assert be._prefix.evict(pool, 2) == 2
    assert pool.n_free == eng.n_pages


def test_second_request_hits_and_emits_identically(stablelm):
    _, _, model, params = stablelm
    p = _shared_prompts(model.cfg.vocab, 12, (5,))[0]
    off, _ = _run(model, params, [p, p], prefix_cache=False, budget=8,
                  n_slots=1)
    on, eng = _run(model, params, [p, p], prefix_cache=True, budget=8,
                   n_slots=1)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    pf = eng.page_stats()["prefix"]
    assert pf["tokens_matched"] > 0 and pf["hit_rate"] > 0


def test_cow_on_page_aligned_hit(stablelm):
    _, _, model, params = stablelm
    p = np.random.RandomState(3).randint(0, model.cfg.vocab,
                                         (8,)).astype(np.int32)
    off, _ = _run(model, params, [p, p, p], prefix_cache=False, budget=6)
    on, eng = _run(model, params, [p, p, p], prefix_cache=True, budget=6)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    pf = eng.page_stats()["prefix"]
    assert pf["cow_copies"] >= 1 and pf["collisions_rejected"] == 0


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_shared_vs_unshared_bit_parity(stablelm, temp):
    _, _, model, params = stablelm
    prompts = _shared_prompts(model.cfg.vocab, 12, (5, 3, 7, 6))
    off, _ = _run(model, params, prompts, prefix_cache=False, temp=temp)
    on, eng = _run(model, params, prompts, prefix_cache=True, temp=temp)
    for i, (a, b) in enumerate(zip(off, on)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert eng.page_stats()["prefix"]["hit_rate"] > 0


def test_moe_shared_vs_unshared_bit_parity():
    _, _, model, params = _carried("granite_moe_3b_a800m")
    prompts = _shared_prompts(model.cfg.vocab, 12, (5, 3, 7, 6))
    off, _ = _run(model, params, prompts, prefix_cache=False, temp=0.8)
    on, eng = _run(model, params, prompts, prefix_cache=True, temp=0.8)
    for i, (a, b) in enumerate(zip(off, on)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert eng.page_stats()["prefix"]["hit_rate"] > 0


def test_parity_through_preemption_of_a_sharing_request(stablelm):
    """A 9-page pool: the prefix engine preempts requests that share pages
    and evicts index entries mid-run; streams stay bit-equal to the
    unshared engine's, and every page is free or held by the index."""
    _, _, model, params = stablelm
    prompts = _shared_prompts(model.cfg.vocab, 12, (5, 3, 7, 6))
    off, _ = _run(model, params, prompts, prefix_cache=False, n_pages=9)
    on, eng = _run(model, params, prompts, prefix_cache=True, n_pages=9)
    for i, (a, b) in enumerate(zip(off, on)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = eng.page_stats()
    assert st["preemptions"] > 0 and st["prefix"]["evictions"] > 0
    assert st["n_free"] + st["prefix"]["cached_pages"] == eng.n_pages


def test_submit_error_accounts_for_shared_hits(stablelm):
    _, _, model, params = stablelm
    eng = ServeEngine(model, params, max_len=48, n_slots=2, page_size=16,
                      n_pages=8, prefill_chunk=16, prefix_cache=True,
                      device="cpu")
    rng = np.random.RandomState(7)
    head = rng.randint(0, model.cfg.vocab, (32,)).astype(np.int32)
    eng.submit(head, 4)                     # lands 2 pages in the index
    eng.run()
    over = np.concatenate([head, rng.randint(
        0, model.cfg.vocab, (68,)).astype(np.int32)])
    with pytest.raises(AdmissionRejected,
                       match=r"paged mode.*shared via the prefix cache"
                             r".*page-table"):
        eng.submit(over, 100)


def _engine_vs_reference(jmodel, jparams, model, params):
    """Greedy traffic with a shared prefix through the port's prefix engine
    and the JAX one: the same streams, statuses, matched tokens and
    copies."""
    prompts = _shared_prompts(model.cfg.vocab, 12, (5, 3, 7, 6, 0))
    kw = {"max_len": 64, "n_slots": 2, "page_size": 4, "pages_per_slot": 16,
          "prefill_chunk": 4, "prefix_cache": True}
    out = {}
    for name, eng in (("port", ServeEngine(model, params, device="cpu",
                                           **kw)),
                      ("reference", JServeEngine(jmodel, jparams, **kw))):
        rids = [eng.submit(p, 10) for p in prompts]
        eng.run()
        out[name] = ([eng.result(r) for r in rids], eng.page_stats())
    (got, stats), (want, jstats) = out["port"], out["reference"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == w.status == OK
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")
    assert stats["prefix"] == jstats["prefix"]
    assert stats["prefix"]["tokens_matched"] > 0
    assert stats["prefix"]["cow_copies"] >= 1


def test_engine_matches_reference_engine(stablelm):
    _engine_vs_reference(*stablelm)


def test_moe_engine_matches_reference_engine():
    """The MoE case of the above (``granite_moe_3b_a800m``, top 8 of 40
    experts padded to 48): routing through shared pages leaves streams,
    statuses and the prefix counters equal to the JAX engine's."""
    _engine_vs_reference(*_carried("granite_moe_3b_a800m"))

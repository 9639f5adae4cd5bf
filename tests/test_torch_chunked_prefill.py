"""The port's chunked prefill against the JAX reference, on the CPU (the
counterpart of ``tests/test_chunked_prefill.py``).

- ``ChunkPlan`` walks a prompt as the reference's does.
- ``ops.flash_chunk_attention`` against the reference's (XLA on every
  impl), contiguous and paged, with and without ALiBi: valid rows at
  ``atol 2e-5`` in float32.
- ``lm.prefill_chunk`` against the reference's at float32 SMOKE: two chunk
  calls per case (a prompt's first chunk beside whole short prompts and a
  frozen row, then its final chunk), on a dense contiguous cache, a dense
  paged cache with ``pages_phi``, and the SSM state carried across the
  calls (chunk 12 over an SSD chunk of 8, so neither divides the other).
  Logits of finalized rows at ``atol 1e-4``, caches at ``atol 1e-5``;
  frozen rows bit-identical; a chunk plan on a device is refused.
- The engine: chunked == whole-prompt greedy streams (and the streaming
  sink) on ``stablelm_12b`` contiguous and paged, ``gpt2_alibi_15b`` paged
  and ``mamba2_130m``; the port's chunked engine == the JAX chunked
  engine, streams and statuses; sampled streams unchanged by chunking; an
  unchunked backend reports nothing pending; a request preempted mid-chunk
  resumes bit-identically.

The reference's ring-KV (sliding-window) case is in ``test_torch_hybrid.py``.
Inputs come from numpy seeds; the reference's parameters are
carried across with ``params_from_numpy``.
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
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import ChunkPlan as JChunkPlan
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.models import get_model
from repro_torch.serve import OK, SamplingParams, ServeEngine
from repro_torch.serve.scheduler import ChunkPlan, Request


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(arch, **replace):
    jcfg = jsmoke(arch).replace(attn_impl="xla", **replace)
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


def _prompts(vocab, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _traffic(engine, prompts, budget=6, temp=0.0, streams=None):
    """Staggered arrivals: half queue up front, the rest join one per step
    while earlier requests are mid-decode or mid-chunk."""
    rids = []

    def submit(i):
        cb = None if streams is None else streams.setdefault(i, []).append
        rids.append(engine.submit(
            prompts[i], budget, sampling=SamplingParams(temp, 0, seed=i),
            on_token=cb))

    for i in range(len(prompts) // 2):
        submit(i)
    i = len(prompts) // 2
    while len(engine.scheduler) or engine.occupancy or i < len(prompts):
        if i < len(prompts):
            submit(i)
            i += 1
        engine.step()
    return [engine.result(r) for r in rids]


# ---------------------------------------------------------------------------
# ChunkPlan
# ---------------------------------------------------------------------------

def test_chunk_plan_walks_the_prompt():
    toks = np.arange(11, dtype=np.int32)
    plan, jplan = ChunkPlan(Request(0, toks, 4)), JChunkPlan(JRequest(0, toks,
                                                                      4))
    assert plan.remaining == 11
    for want_off, want_last in ((0, False), (4, False), (8, True)):
        off, chunk, last = plan.next_chunk(4)
        joff, jchunk, jlast = jplan.next_chunk(4)
        assert (off, last) == (want_off, want_last) == (joff, jlast)
        np.testing.assert_array_equal(chunk, toks[off:off + 4])
        np.testing.assert_array_equal(chunk, jchunk)
    assert plan.remaining == 0 == jplan.remaining


# ---------------------------------------------------------------------------
# flash_chunk_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", ["alibi", "none"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunk_attention_matches_reference(paged, bias):
    rng = np.random.default_rng(0)
    b, c, kvh, g, d, s, ps = 3, 8, 2, 2, 16, 32, 4
    q = rng.standard_normal((b, c, kvh * g, d)).astype(np.float32)
    offsets = np.array([0, 13, 24], np.int32)
    chunk_lens = np.array([8, 5, 0], np.int32)
    slopes = (rng.uniform(0.05, 0.5, kvh * g).astype(np.float32)
              if bias == "alibi" else None)
    kw, tkw = {}, {}
    if paged:
        n_pages = b * s // ps + 3
        shape = (kvh, n_pages, ps, d)
        table = rng.permutation(n_pages)[:b * s // ps].reshape(b, s // ps)
        table[2, 2:] = n_pages                      # sentinel entries
        table = table.astype(np.int32)
        kw = {"page_table": jnp.asarray(table), "max_pages": 6}
        tkw = {"page_table": torch.tensor(table), "max_pages": 6}
    else:
        shape = (b, kvh, s, d)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = jops.flash_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets),
        jnp.asarray(chunk_lens), None if slopes is None else
        jnp.asarray(slopes), impl="xla", kv_layout="bhsd", **kw)
    got = tops.flash_chunk_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), offsets,
        chunk_lens, None if slopes is None else torch.tensor(slopes),
        kv_layout="bhsd", **tkw)
    live = np.arange(c)[None, :] < chunk_lens[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# prefill_chunk
# ---------------------------------------------------------------------------

CASES = {"gpt2-contiguous": ("gpt2_alibi_15b", False, {}),
         "stablelm-contiguous": ("stablelm_12b", False, {}),
         "gpt2-paged": ("gpt2_alibi_15b", True, {}),
         "stablelm-paged": ("stablelm_12b", True, {}),
         "mamba2": ("mamba2_130m", False, {"ssd_chunk": 8})}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_chunk_matches_reference(case):
    arch, paged, replace = CASES[case]
    jmodel, jparams, model, params = _carried(arch, **replace)
    cfg, jcfg = model.cfg, jmodel.cfg
    b, c, max_len, ps = 3, 12, 32, 4
    if paged:
        n_pages = b * max_len // ps + 2
        table = np.random.default_rng(5).permutation(n_pages)[
            :b * max_len // ps].reshape(b, max_len // ps).astype(np.int32)
        cache = model.init_paged_cache(b, n_pages, ps, max_len // ps,
                                       device="cpu")
        cache["page_table"][:] = torch.tensor(table)
        jcache = jlm.init_paged_cache(jcfg, b, n_pages, ps, max_len // ps)
        jcache["page_table"] = jnp.asarray(table)
        kw = {"max_pages": max_len // ps}
    else:
        cache = model.init_cache(b, max_len, device="cpu")
        jcache = jlm.init_cache(jcfg, b, max_len)
        kw = {}
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (20,))
    # call 1: row 0 the prompt's first chunk (mid-prompt), rows 1-2 whole
    # 7- and 0-token (frozen) prompts; call 2: row 0's final chunk, the
    # others frozen
    calls = [(np.zeros(b, np.int64), np.array([c, 7, 0]),
              np.array([-1, 7, -1])),
             (np.array([c, 0, 0]), np.array([8, 0, 0]),
              np.array([20, -1, -1]))]
    for n, (offs, clens, flens) in enumerate(calls):
        toks = rng.integers(0, cfg.vocab, (b, c))
        toks[0, :clens[0]] = prompt[offs[0]:offs[0] + clens[0]]
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            logits, cache = model.prefill_chunk(
                params, cache, torch.tensor(toks), offs, clens, flens, **kw)
        jlogits, jcache = jlm.prefill_chunk(
            jparams, jcache, jnp.asarray(toks, jnp.int32), jcfg,
            offsets=offs, chunk_lens=clens, final_lens=flens, **kw)
        done = flens >= 0
        np.testing.assert_allclose(logits.numpy()[done],
                                   np.asarray(jlogits)[done], atol=1e-4,
                                   rtol=0, err_msg=f"call {n}")
        assert cache["length"].tolist() == np.asarray(
            jcache["length"]).tolist()
        for key, val in cache.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(jcache[key]),
                                       atol=1e-5, rtol=0,
                                       err_msg=f"call {n} {key}")
            if key.startswith(("k", "v", "ssm", "conv")):   # per-row leaves
                frozen = np.nonzero(clens == 0)[0]
                assert torch.equal(val[:, frozen], before[key][:, frozen])


def test_prefill_chunk_refuses_device_resident_plans():
    """The chunk plan is the host's: offsets on a device are refused, not
    read back (a ``meta`` tensor stands in for one on the card)."""
    _, _, model, params = _carried("gpt2_alibi_15b")
    cache = model.init_cache(2, 16, device="cpu")
    with pytest.raises(ValueError, match="host"):
        model.prefill_chunk(params, cache,
                            torch.zeros((2, 4), dtype=torch.long),
                            torch.zeros(2, dtype=torch.long, device="meta"),
                            np.array([4, 0]), np.array([-1, -1]))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_CASES = {"stablelm-contiguous": ("stablelm_12b", False),
                "stablelm-paged": ("stablelm_12b", True),
                "gpt2-paged": ("gpt2_alibi_15b", True),
                "mamba2": ("mamba2_130m", False)}


def _kw(paged):
    kw = {"max_len": 48, "n_slots": 3}
    if paged:
        kw.update(page_size=4, pages_per_slot=12)
    return kw


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_chunked_matches_whole_prompt_engine(case):
    arch, paged = ENGINE_CASES[case]
    _, _, model, params = _carried(arch)
    prompts = _prompts(model.cfg.vocab, (13, 6, 17, 9, 5), seed=2)
    whole = _traffic(ServeEngine(model, params, device="cpu", **_kw(paged)),
                     prompts)
    streams = {}
    eng = ServeEngine(model, params, prefill_chunk=5, device="cpu",
                      **_kw(paged))
    chunked = _traffic(eng, prompts, streams=streams)
    assert eng.stats()["chunk_steps"] > 0 and eng.stats()[
        "prefill_waves"] == 0
    for i, (a, b) in enumerate(zip(whole, chunked)):
        assert b.status == OK and b.size == 6
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
        np.testing.assert_array_equal(np.asarray(streams[i], np.int32), b)


@pytest.mark.parametrize("case", ["stablelm-contiguous", "gpt2-paged",
                                  "mamba2"])
def test_chunked_engine_matches_reference_engine(case):
    arch, paged = ENGINE_CASES[case]
    jmodel, jparams, model, params = _carried(arch)
    prompts = _prompts(model.cfg.vocab, (13, 6, 17, 9, 5), seed=3)
    want = _traffic(JServeEngine(jmodel, jparams, prefill_chunk=4,
                                 **_kw(paged)), prompts)
    got = _traffic(ServeEngine(model, params, prefill_chunk=4, device="cpu",
                               **_kw(paged)), prompts)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == w.status == OK, (g.status, w.status)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_sampled_stream_parity(paged):
    """Sampling state is armed at plan time and committed only for decoding
    slots, so each request's sampling stream advances as it does when its
    prompt lands whole."""
    _, _, model, params = _carried("stablelm_12b")
    prompts = _prompts(model.cfg.vocab, (12, 7, 15, 6), seed=3)
    whole = _traffic(ServeEngine(model, params, device="cpu", **_kw(paged)),
                     prompts, temp=0.8)
    chunked = _traffic(ServeEngine(model, params, prefill_chunk=4,
                                   device="cpu", **_kw(paged)),
                       prompts, temp=0.8)
    for i, (a, b) in enumerate(zip(whole, chunked)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_unchunked_backend_reports_no_pending():
    _, _, model, params = _carried("stablelm_12b")
    eng = ServeEngine(model, params, max_len=32, n_slots=2, device="cpu")
    eng.submit(_prompts(model.cfg.vocab, (9,))[0], 4)
    eng.step()
    assert not eng.backend.prefill_pending()
    assert not list(eng.backend.pending_slots())
    eng.run()
    assert eng.stats()["chunk_steps"] == 0


def _priority_run(model, params, preempt_mid_chunk):
    """A high-class request decoding, a low-class long prompt admitted and
    caught mid-chunk; optionally preempted (default victim) right there."""
    eng = ServeEngine(model, params, max_len=48, n_slots=2, prefill_chunk=4,
                      page_size=4, pages_per_slot=12, device="cpu")
    p_hi, p_lo = _prompts(model.cfg.vocab, (6, 18), seed=9)
    stream = []
    r_hi = eng.submit(p_hi, 10, priority=1)
    for _ in range(3):                 # 2 chunks to land + 1 decode step
        eng.step()
    r_lo = eng.submit(p_lo, 6, priority=0, on_token=stream.append)
    eng.step()                         # admit + first chunk, hi decodes
    if preempt_mid_chunk:
        (slot, plan), = eng.backend._pending.items()
        assert plan.req.rid == r_lo
        assert 0 < plan.done < plan.req.tokens.size
        assert eng.preempt() == r_lo
        # nothing generated: the snapshot is the original request, whole
        resumed = eng.scheduler.peek()
        assert resumed.rid == r_lo and resumed.max_new_tokens == 6
        np.testing.assert_array_equal(resumed.tokens, p_lo)
    eng.run()
    assert eng.page_stats()["n_free"] == eng.n_pages
    return eng.result(r_hi), eng.result(r_lo), stream


def test_mid_chunk_preemption_resumes_bit_identically():
    _, _, model, params = _carried("stablelm_12b")
    hi0, lo0, _ = _priority_run(model, params, preempt_mid_chunk=False)
    hi1, lo1, stream = _priority_run(model, params, preempt_mid_chunk=True)
    np.testing.assert_array_equal(hi0, hi1)
    np.testing.assert_array_equal(lo0, lo1)
    np.testing.assert_array_equal(np.asarray(stream, np.int32), lo1)
